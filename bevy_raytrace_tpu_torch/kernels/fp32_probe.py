"""V1-V3: the rate probes of the dense sweep's arithmetic, on CUDA
(`csrc/fp32_probe.cu`) and in plain PyTorch.

Counterparts of the kernel factories of `tools/vpu_probe.py`:

  V1 `v1_sweep`  `iters` rounds of the ray-sphere chain (centered half-b,
                 sqrt, near/far root, t > t_min, min over the spheres), the
                 result fed back into the ray origin (`sweep_kernel`);
  V2 `v2_fma`    `iters` rounds of 16 multiply-adds in 4 chains per (sphere
                 row, ray) element, then the min over the rows; float32 or
                 bfloat16, by the operands' type (`fma_kernel`);
  V3 `v3_sweep`  the production sweep, every ray row perturbed by the
                 carry: the nearest hit and its index (`sweep_full_dep`).
                 Its "k1" form runs K1's own loop (`brt::sweep_nearest` in
                 `csrc/common.cuh`; K4 keeps a copy of it), "prod" the same
                 tests scheduled for the card.

Operands as the tool's: g [S, 8] (columns 0-3: cx, cy, cz, r^2), r [8, R]
(rows 0-5: origin, direction), outputs [1, R].  `VARIANTS` names V3's
forms: "prod" (K1's arithmetic with the table in shared memory and two
rays a thread: the same bits as "k1"), "nosqrt" (the discriminant in the
root's place, no branch on its sign: the tool's), "nobranch" (the root of
every sphere; a negative discriminant gives NaN, which is no hit), "smem"
(K1's loop with the table in shared memory, the mode K1 runs at these table
sizes) and "k1" (K1's loop on its device-memory, global, table).  "prod",
"smem" and "k1" share one plain version.  A ray with no valid hit gives
t = NaN, index -1.

Each wrapper checks its operands and, on CUDA tensors, launches its kernel
and adds one to its counter (`v1.launches` ... `v3.launches` in
`utils.spans`); on CPU tensors it runs the `*_plain` version beside it on
[S, R] planes (what the kernel is held against on the card); any other
device raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bevy_raytrace_tpu_torch.kernels.probes import _bind, _launch
from bevy_raytrace_tpu_torch.kernels.render_lanes import _check

T_MIN = 1e-3
CARRY_SCALE = 1e-30
VARIANTS = ("prod", "nosqrt", "nobranch", "smem", "k1")
MAX_SPHERES = 3072  # "prod" and "smem" keep 16 bytes a sphere in 48 KB

# Float operations per (sphere, ray, round), counted from the CUDA source
# with a fused multiply-add as two.  V1: the discriminant (oc 3, hb 5, cq 6,
# disc 2), the sqrt, both roots and the min: 20.  V2: 16 multiply-adds and 3
# adds: 35.  V3: the discriminant, 16; the root is needed only where it is
# positive and is not counted, in any variant (chip_smoke.py counts K1's and
# K4's sweeps the same way, so the shares compare).
OPS = {"v1": 20, "v2": 35, "v3": 16}


_vp, _i32 = ctypes.c_void_p, ctypes.c_int
# Each launcher's argument types, the stream last (csrc/fp32_probe.cu).
SIGNATURES = {
    "brt_v1_sweep": [_vp, _vp, _vp, _i32, _i32, _i32, _vp],
    "brt_v2_fma": [_vp, _vp, _vp, _i32, _i32, _i32, _i32, _vp],
    "brt_v3_sweep": [_vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _vp],
    "brt_v1_root_check": [ctypes.c_uint, ctypes.c_uint, _vp, _vp, _vp, _vp]}


@functools.lru_cache(maxsize=1)
def _launchers():
    return _bind("fp32_probe", SIGNATURES)


def _check_operands(g, r, iters, dtype=torch.float32, min_iters=0):
    device = g.device if isinstance(g, torch.Tensor) else None
    _check("g", g, dtype, (None, 8), device)
    _check("r", r, dtype, (8, None), device)
    if g.shape[0] == 0 or r.shape[1] == 0:
        raise ValueError("need at least one sphere row and one ray")
    if int(iters) != iters or iters < min_iters:
        raise ValueError(f"iters must be an integer >= {min_iters}, "
                         f"got {iters}")
    return device, g.shape[0], r.shape[1]


def _chain(g, r, carry_rows):
    """(hb, disc) [S, R] of the centered half-b quadratic; `carry_rows`
    [6] of [1, R]: the perturbed origin and direction rows."""
    cx, cy, cz, r2 = (g[:, k:k + 1] for k in range(4))
    ox, oy, oz, dx, dy, dz = carry_rows
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    hb = ocx * dx + ocy * dy + ocz * dz
    cq = (ocx * ocx + ocy * ocy + ocz * ocz) - r2
    return hb, hb * hb - cq


# --- V1 ---------------------------------------------------------------------


def v1_sweep_plain(g, r, iters):
    """V1 on [S, R] planes."""
    rows = [r[k:k + 1] for k in range(6)]
    carry = torch.zeros_like(rows[0])
    for _ in range(iters):
        hb, disc = _chain(g, r, [rows[0] + carry * CARRY_SCALE, *rows[1:]])
        sq = torch.sqrt(disc)  # NaN where negative: then no hit
        rn, rf = -hb - sq, sq - hb
        tn = torch.where(rn > T_MIN, rn, rf)
        picked = torch.where(tn > T_MIN, tn, 3.0)
        carry = picked.min(dim=0, keepdim=True).values
    return carry + 1.0


def v1_sweep(g, r, iters: int):
    """V1: g float32 [S, 8], r float32 [8, R] -> 1 + the last round's
    smallest valid t (3.0 standing for a sphere's miss), [1, R].  The
    kernel sweeps two rays a thread on a staged table and takes the root by
    MUFU.RSQ and one correction: sqrtf's bits wherever a root can be picked
    (`v1_root_check`), so the plain version's bits where both round
    alike."""
    device, s, n = _check_operands(g, r, iters)
    if device.type == "cpu":
        return v1_sweep_plain(g, r, iters)
    out = torch.empty((1, n), dtype=torch.float32, device=device)
    _launch("v1", _launchers, "brt_v1_sweep", device, g.data_ptr(),
            r.data_ptr(), out.data_ptr(), s, n, int(iters))
    return out


def v1_root_check(lo: int, hi: int, device="cuda"):
    """Test-only: the root V1's kernel takes (`v1_root` in
    `csrc/fp32_probe.cu`) against `__fsqrt_rn` on every float32 bit pattern
    in [lo, hi) -> (how many differ in any bit, the lowest that does or
    None, the most units in the last place between the two)."""
    device = torch.device(device)
    if device.type != "cuda" or not 0 <= lo < hi <= 1 << 32 or \
            hi - lo >= 1 << 32:
        raise ValueError(f"needs a CUDA device and [lo, hi) within 32 bits, "
                         f"got {device}, [{lo}, {hi})")
    out = torch.tensor([0, 0xFFFFFFFF, 0], dtype=torch.int64, device=device)
    fn = _launchers()["brt_v1_root_check"]
    with torch.cuda.device(device):
        err = fn(lo, hi - lo, out.data_ptr(), out.data_ptr() + 8,
                 out.data_ptr() + 16,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"brt_v1_root_check failed with cudaError_t {err}")
    count, lowest, ulps = (int(v) for v in out.cpu())
    return count, (lowest if count else None), ulps


# --- V2 ---------------------------------------------------------------------


def v2_fma_plain(g, r, iters):
    """V2 on the [S, R] plane, in the operands' type (the constants round
    to it first, as the tool's do)."""
    m1, m2, m3, m4, k1, k2 = (
        torch.tensor(v, dtype=g.dtype, device=g.device)
        for v in (1.0001, 0.9999, 1.0002, 0.9998, 0.1, 0.2))
    x = g[:, 0:1] * r[0:1, :]
    for _ in range(iters):
        a = x * m1 + k1
        b = x * m2 + k2
        c = a * m3 + b
        d = b * m4 + a
        for _ in range(3):
            a = a * m1 + c
            b = b * m2 + d
            c = c * m3 + a
            d = d * m4 + b
        x = a + b + c + d
    return x.to(torch.float32).min(dim=0, keepdim=True).values


def v2_fma(g, r, iters: int):
    """V2: g [S, 8], r [8, R], both float32 or both bfloat16 (R even) ->
    float32 [1, R], the min over the rows of x after `iters` rounds from x =
    g[:, 0] * r[0, :]."""
    dtype = g.dtype if isinstance(g, torch.Tensor) else None
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"g must be float32 or bfloat16, got {dtype}")
    device, s, n = _check_operands(g, r, iters, dtype)
    bf16 = dtype == torch.bfloat16
    if bf16 and n % 2:
        raise ValueError(f"the bfloat16 form takes an even number of rays "
                         f"(two to a lane), got {n}")
    if device.type == "cpu":
        return v2_fma_plain(g, r, iters)
    out = torch.empty((1, n), dtype=torch.float32, device=device)
    _launch("v2", _launchers, "brt_v2_fma", device, g.data_ptr(),
            r.data_ptr(), out.data_ptr(), s, n, int(iters), int(bf16))
    return out


# --- V3 ---------------------------------------------------------------------


def v3_sweep_plain(g, r, iters, variant="prod"):
    """V3 on [S, R] planes -> (t [1, R], index int32 [1, R])."""
    s = g.shape[0]
    rows = [r[k:k + 1] for k in range(6)]
    ids = torch.arange(s, device=g.device)[:, None]
    carry = torch.zeros_like(rows[0])
    for _ in range(iters):
        e = carry * CARRY_SCALE
        hb, disc = _chain(g, r, [row + e for row in rows])
        if variant == "nosqrt":
            sq, ok = disc, True
        elif variant == "nobranch":
            sq, ok = torch.sqrt(disc), True
        else:
            sq, ok = disc * torch.rsqrt(disc), disc > 0.0
        rn = -hb - sq
        tn = torch.where(rn > T_MIN, rn, sq - hb)
        t = torch.where((tn > T_MIN) & ok, tn, float("inf"))
        best_t = t.min(dim=0, keepdim=True).values
        miss = torch.isinf(best_t)
        idx = torch.where(t == best_t, ids, s).min(dim=0, keepdim=True).values
        carry = torch.where(miss, 0.0, best_t)
    return (torch.where(miss, float("nan"), best_t),
            torch.where(miss, -1, idx).to(torch.int32))


def v3_sweep(g, r, iters: int, variant: str = "prod"):
    """V3: g float32 [S, 8], r float32 [8, R], `iters` >= 1 rounds -> (the
    nearest valid t [1, R], its sphere int32 [1, R]); the lowest index wins
    a tie; no hit gives (NaN, -1)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    device, s, n = _check_operands(g, r, iters, min_iters=1)
    if s > MAX_SPHERES:
        raise ValueError(f"V3 takes at most {MAX_SPHERES} spheres, got {s}")
    if device.type == "cpu":
        return v3_sweep_plain(g, r, iters, variant)
    t = torch.empty((1, n), dtype=torch.float32, device=device)
    idx = torch.empty((1, n), dtype=torch.int32, device=device)
    _launch("v3", _launchers, "brt_v3_sweep", device, g.data_ptr(),
            r.data_ptr(), t.data_ptr(), idx.data_ptr(), s, n, int(iters),
            VARIANTS.index(variant))
    return t, idx
