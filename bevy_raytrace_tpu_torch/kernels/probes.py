"""P1-P5: the five construct probes, on CUDA (`csrc/probes.cu`) and in
plain PyTorch.

Counterparts of the five functions of `tools/proto_mxu.py`, which ask the
TPU's compiler whether a render kernel may be built on a construct:

  P1 `p1_while`          a loop that runs while ANY lane is alive, with
                         per-lane carries (`p1_while_vreg_carry`);
  P2 `p2_dot`            an in-kernel float32 product (`p2_dot`);
  P3 `p3_reshape`        [rows, 128] -> [1, rows * 128], x 2, and back
                         (`p3_reshape`);
  P4 `p4_min`            per column, the minimum over the rows and its row
                         (`p4_min_packed`);
  P5 `p5_onehot_gather`  per column, the attribute columns of the rows equal
                         to the column's key: attr @ (packed == m)
                         (`p5_onehot_gather`).

Each wrapper checks its operands and, on CUDA tensors, launches its kernel
and adds one to its counter (`p1.launches` ... `p5.launches` in
`utils.spans`); on CPU tensors it runs the `*_plain` version beside it (the
function the kernel is held against on the card); any other device raises.
On the card P1 runs as one thread block cluster of 8 blocks whose warps
each vote on their own lanes and meet once for the round count,
P2 as a block of 256 threads a 64 x 64 tile of c, stored 128 bits at a
time, and P3 as a float4 a thread on a 64-bit index (`csrc/probes.cu` says
why).  Where the TPU kernel uses a device of that machine, the port
computes the function itself: P4 returns the exact minimum and the exact
row (the TPU packs the row into the low 9 bits of the value, which
truncates the value and mis-orders near-ties), with NaN ordered above every
number as that key orders it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bevy_raytrace_tpu_torch.kernels import build
from bevy_raytrace_tpu_torch.kernels.render_lanes import _check
from bevy_raytrace_tpu_torch.utils.spans import count

LANES = 128
P1_SHAPE = (8, LANES)
P2_TILE, P2_K = 64, 16
P5_ATTRS = 16


def _bind(library, sigs):
    """Build (at first use) and load `csrc/<library>.cu` -> {name: its
    extern "C" launcher}; `sigs` names each launcher's argument types, the
    stream last, and every one returns its launch's cudaError_t."""
    lib = build.load(library)
    out = {}
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        out[name] = fn
    return out


_vp, _i32 = ctypes.c_void_p, ctypes.c_int
# Each launcher's argument types, the stream last (csrc/probes.cu).
SIGNATURES = {
    "brt_p1_while": [_vp, _vp, _vp, _vp],
    "brt_p2_dot": [_vp, _vp, _vp, _i32, _i32, _i32, _vp],
    "brt_p3_reshape": [_vp, _vp, ctypes.c_int64, _vp],
    "brt_p4_min": [_vp, _vp, _vp, _i32, _i32, _vp],
    "brt_p5_gather": [_vp, _vp, _vp, _vp, _i32, _i32, _vp]}


@functools.lru_cache(maxsize=1)
def _launchers():
    return _bind("probes", SIGNATURES)


def _check_ints(name, argtypes, args):
    """Raise ValueError where an integer of `args` does not fit the ctypes
    integer type of its slot in `argtypes`: ctypes would wrap it silently
    (2^31 + 5 in a c_int arrives as -2^31 + 5)."""
    for k, (ctype, value) in enumerate(zip(argtypes, args)):
        code = getattr(ctype, "_type_", "")
        if not code or code not in "bBhHiIlLqQ":
            continue
        bits = 8 * ctypes.sizeof(ctype)
        lo, hi = ((-(1 << bits - 1), (1 << bits - 1) - 1) if code.islower()
                  else (0, (1 << bits) - 1))
        if not lo <= value <= hi:
            raise ValueError(f"{name}: argument {k} = {value} does not fit "
                             f"its {ctype.__name__} ([{lo}, {hi}])")


def _launch(kernel, launchers, name, device, *args):
    """Launch `launchers()[name]` on `device`'s current stream and count it
    in the counter `<kernel>.launches`; raises where the device is not CUDA,
    an integer argument does not fit its C type, or the launch is
    refused."""
    if device.type != "cuda":
        raise ValueError(f"{kernel.upper()} runs on CUDA (or its plain "
                         f"version on CPU), not {device}")
    fn = launchers()[name]
    _check_ints(name, fn.argtypes, args)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {err}")
    count(f"{kernel}.launches")


# --- P1 ---------------------------------------------------------------------


def p1_while_plain(x):
    """P1 in tensor ops -> (out [8, 128], rounds int32 [1])."""
    a, b = x.clone(), x * 2.0
    alive = torch.ones_like(x, dtype=torch.bool)
    rounds = 0
    while bool(alive.any()):
        a = a + 1.0
        b = b * 1.01 + a * 0.001
        alive = alive & (a < 50.0)
        rounds += 1
    return (b + float(rounds),
            torch.tensor([rounds], dtype=torch.int32, device=x.device))


def p1_while(x):
    """P1: from a = x, b = 2x, every round does a += 1; b = b * 1.01 + a *
    0.001; alive &= a < 50, while ANY lane is alive; a dead lane's carries
    go on updating until the last lane dies.  x float32 [8, 128] ->
    (b + rounds [8, 128], rounds int32 [1]).  The kernel: a cluster of 8
    blocks of 128 threads, a lane a thread; each warp votes on its own
    lanes, the warps agree on the largest count once, and a warp whose lanes
    died early runs the remaining rounds alone.

    A warp waits for the others' counts at most 10 s and then traps (a lane
    below -2^24, whose a + 1 no longer grows, would run forever, as the
    reference's loop does).  A device-side trap is not an ordinary launch
    error: the next synchronizing call raises, and the process's CUDA
    context stays unusable, so every later CUDA call of the process fails."""
    device = x.device if isinstance(x, torch.Tensor) else None
    _check("x", x, torch.float32, P1_SHAPE, device)
    if device.type == "cpu":
        return p1_while_plain(x)
    out = torch.empty_like(x)
    rounds = torch.empty((1,), dtype=torch.int32, device=device)
    _launch("p1", _launchers, "brt_p1_while", device, x.data_ptr(),
            out.data_ptr(), rounds.data_ptr())
    return out, rounds


# --- P2 ---------------------------------------------------------------------


def p2_dot_plain(a, b):
    """P2 in one tensor op: a @ b in float32."""
    return a @ b


def p2_dot(a, b):
    """P2: a [M, K] @ b [K, N] in float32 by the kernel's own tiles (M and
    N multiples of 64, K of 16) -> [M, N].  The kernel: a block of 256
    threads a 64 x 64 tile of c, a thread four consecutive columns of 4 rows,
    each element fmaf over k ascending, each row stored as one 128-bit store
    when summed; a and b must be 16-byte aligned (a tensor of its own is;
    the launch is refused otherwise)."""
    device = a.device if isinstance(a, torch.Tensor) else None
    _check("a", a, torch.float32, (None, None), device)
    m, k = a.shape
    _check("b", b, torch.float32, (k, None), device)
    n = b.shape[1]
    if m % P2_TILE or n % P2_TILE or k % P2_K or 0 in (m, n, k):
        raise ValueError(f"P2 takes M and N multiples of {P2_TILE} and K a "
                         f"multiple of {P2_K}, got {m}x{k} @ {k}x{n}")
    if device.type == "cpu":
        return p2_dot_plain(a, b)
    c = torch.empty((m, n), dtype=torch.float32, device=device)
    _launch("p2", _launchers, "brt_p2_dot", device, a.data_ptr(),
            b.data_ptr(), c.data_ptr(), m, n, k)
    return c


# --- P3 ---------------------------------------------------------------------


def p3_reshape_plain(x):
    """P3 in tensor ops: through the flat view, times 2, and back."""
    return (x.reshape(1, -1) * 2.0).reshape(x.shape)


def p3_reshape(x):
    """P3: x float32 [rows, 128] -> 2x through a [1, rows * 128] view and
    back -> [rows, 128], bit for bit x * 2, any rows >= 1 (a 64-bit index).
    The kernel: a float4 a thread with streaming loads and stores, 256
    threads a block.  x must start on 16 bytes (a tensor of its own does):
    a view that does not is refused by the launcher and raises here, as P2's
    operands are; it is never read in pieces or run on the plain version."""
    device = x.device if isinstance(x, torch.Tensor) else None
    _check("x", x, torch.float32, (None, LANES), device)
    if x.shape[0] == 0:
        raise ValueError("P3 takes at least one row")
    if device.type == "cpu":
        return p3_reshape_plain(x)
    out = torch.empty_like(x)
    _launch("p3", _launchers, "brt_p3_reshape", device, x.data_ptr(),
            out.data_ptr(), x.shape[0])
    return out


# --- P4 ---------------------------------------------------------------------


def p4_min_plain(t):
    """P4 in tensor ops: per column the lowest row of the exact minimum, a
    NaN never winning against a number (an all-NaN column gives row 0), and
    the value that row holds."""
    s, r = t.shape
    nan = torch.isnan(t)
    m = torch.where(nan, float("inf"), t).min(dim=0).values
    rows = torch.arange(s, device=t.device)[:, None].expand(s, r)
    row = torch.where(t == m, rows, s).min(dim=0).values
    row = torch.where(nan.all(dim=0), 0, row)
    return (t.gather(0, row[None]).reshape(-1, LANES),
            row.to(torch.int32).reshape(-1, LANES))


def p4_min(t):
    """P4: t float32 [S, R] (R a multiple of 128) -> (column minimum
    [R/128, 128], its row int32 [R/128, 128]); the lowest row wins a tie,
    and a NaN never wins against a number: NaN is ordered above +inf, as
    the reference's packed key orders it, and an all-NaN column gives
    (its row 0's NaN, 0)."""
    device = t.device if isinstance(t, torch.Tensor) else None
    _check("t", t, torch.float32, (None, None), device)
    s, r = t.shape
    if s == 0 or r == 0 or r % LANES:
        raise ValueError(f"P4 takes at least one row and a multiple of "
                         f"{LANES} columns, got {s}x{r}")
    if device.type == "cpu":
        return p4_min_plain(t)
    m = torch.empty((r // LANES, LANES), dtype=torch.float32, device=device)
    row = torch.empty((r // LANES, LANES), dtype=torch.int32, device=device)
    _launch("p4", _launchers, "brt_p4_min", device, t.data_ptr(),
            m.data_ptr(), row.data_ptr(), s, r)
    return m, row


# --- P5 ---------------------------------------------------------------------


def p5_onehot_gather_plain(packed, m, attr):
    """P5 as the one-hot product it is."""
    return attr @ (packed == m).to(torch.float32)


def p5_onehot_gather(packed, m, attr):
    """P5: packed int32 [S, R], m int32 [1, R] (the column keys, normally
    the column minima), attr float32 [16, S] -> attr @ (packed == m)
    [16, R]: per column the sum of the attribute columns of the matching
    rows, a tie summed in ascending row order."""
    device = packed.device if isinstance(packed, torch.Tensor) else None
    _check("packed", packed, torch.int32, (None, None), device)
    s, r = packed.shape
    _check("m", m, torch.int32, (1, r), device)
    _check("attr", attr, torch.float32, (P5_ATTRS, s), device)
    if s == 0 or r == 0:
        raise ValueError(f"P5 takes at least one row and one column, got "
                         f"{s}x{r}")
    if device.type == "cpu":
        return p5_onehot_gather_plain(packed, m, attr)
    out = torch.empty((P5_ATTRS, r), dtype=torch.float32, device=device)
    _launch("p5", _launchers, "brt_p5_gather", device,
            packed.data_ptr(), m.data_ptr(), attr.data_ptr(), out.data_ptr(),
            s, r)
    return out
