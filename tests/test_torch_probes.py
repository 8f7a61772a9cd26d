"""The port's probes (`kernels/probes.py` P1-P5, `kernels/fp32_probe.py`
V1-V3) against the reference's tools on the same numpy inputs.

The reference's functions live in `tools/proto_mxu.py` and
`tools/vpu_probe.py`, which are loaded by path; their `pl.pallas_call` runs
in interpret mode for the length of a test (the TPU kernels have no other
form on a CPU).  The port's side is each wrapper on CPU tensors, which runs
the plain PyTorch version the CUDA kernel is held against on the card.
"""

import functools
import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from bevy_raytrace_tpu_torch import set_default_device
from bevy_raytrace_tpu_torch.kernels import fp32_probe as vp
from bevy_raytrace_tpu_torch.kernels import probes as pp
from bevy_raytrace_tpu_torch.utils import spans

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

_TOOLS = os.path.join(os.path.dirname(__file__), os.pardir, "tools")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(_TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """`pl.pallas_call` in interpret mode, as the tools see it."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))


@pytest.fixture(scope="module")
def proto():
    return _load("proto_mxu")


@pytest.fixture(scope="module")
def vpu():
    return _load("vpu_probe")


# --- P1-P5: the reference's own inputs ---------------------------------------


def _p1(proto):
    want = proto.p1_while_vreg_carry()
    out, rounds = pp.p1_while(torch.zeros(8, 128))
    assert int(rounds) == 50 and out.shape == (8, 128)
    np.testing.assert_allclose(want, 51.5108, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5)


def _p2(proto):
    assert proto.p2_dot() == 0.0
    a = np.random.RandomState(0).randn(1024, 16).astype(np.float32)
    b = np.random.RandomState(1).randn(16, 1024).astype(np.float32)
    got = pp.p2_dot(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = a.astype(np.float64) @ b.astype(np.float64)
    # Float32 sums over K = 16 in another order than numpy's float64.
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-6


def _p3(proto):
    assert proto.p3_reshape() == 0.0
    x = np.arange(1024, dtype=np.float32).reshape(8, 128)
    np.testing.assert_array_equal(
        pp.p3_reshape(torch.from_numpy(x)).numpy(), x * 2.0)


def _p4(proto):
    # The reference's packed key clears the low 9 bits of t, so near-ties
    # come out in the wrong order: 8 of its 1,024 rows are not the argmin.
    # The port returns the exact minimum and row.
    assert proto.p4_min_packed() == 8
    t = 1.0 + np.random.RandomState(2).rand(512, 1024).astype(np.float32)
    m, row = pp.p4_min(torch.from_numpy(t))
    assert m.shape == row.shape == (8, 128) and row.dtype == torch.int32
    assert int(np.sum(row.numpy().reshape(-1) != np.argmin(t, axis=0))) == 0
    np.testing.assert_array_equal(m.numpy().reshape(-1), t.min(axis=0))


def _p5(proto):
    assert proto.p5_onehot_gather() == 0.0
    rs = np.random.RandomState(3)
    packed = rs.randint(0, 1 << 20, (512, 1024)).astype(np.int32)
    attr = rs.randn(16, 512).astype(np.float32)
    m = packed.min(axis=0, keepdims=True)
    got = pp.p5_onehot_gather(torch.from_numpy(packed), torch.from_numpy(m),
                              torch.from_numpy(attr)).numpy()
    np.testing.assert_array_equal(got, attr[:, np.argmin(packed, axis=0)])


@pytest.mark.parametrize("case", [_p1, _p2, _p3, _p4, _p5],
                         ids=["p1", "p2", "p3", "p4", "p5"])
def test_probe_matches_reference(interpret, proto, case):
    case(proto)


def _p1_x(case):
    """P1's x [8, 128] for `case` and the rounds it must run: seeded lanes
    in [0, 40); warp 0 (lanes 0-31) at 49.5, dying in round 1, and the rest
    at 0, taking 50; one survivor, lane 1,023 at 0 and the rest at 49.5;
    every lane at x >= 49, one round."""
    if case == "seeded":
        x = np.random.RandomState(7).uniform(0.0, 40.0, (8, 128))
        return x.astype(np.float32), int(np.ceil(50.0 - x.astype(
            np.float32).min()))
    if case == "warp_0_apart":
        x = np.zeros((8, 128), np.float32)
        x.reshape(-1)[:32] = 49.5
        return x, 50
    if case == "one_survivor":
        x = np.full((8, 128), 49.5, np.float32)
        x.reshape(-1)[1023] = 0.0
        return x, 50
    x = np.random.RandomState(8).uniform(49.0, 60.0, (8, 128))
    return x.astype(np.float32), 1


@pytest.mark.parametrize("case", ["seeded", "warp_0_apart", "one_survivor",
                                  "all_above_49"])
def test_p1_lanes_die_in_different_rounds(case):
    """The loop runs until the LAST lane dies, and every lane's carries go
    on updating until then (the reference's loop body masks only `alive`):
    the plain version against the loop in float64 on lanes that die in
    different rounds, in round 1 beside lanes that take 50, or all at once.
    `test_torch_cuda.py` holds the kernel to the plain version on the same
    inputs."""
    x, want_rounds = _p1_x(case)
    out, rounds = pp.p1_while(torch.from_numpy(x))
    n = int(rounds)
    assert n == want_rounds and 1 <= n <= 50
    a, b = x.astype(np.float64), 2.0 * x.astype(np.float64)
    for _ in range(n):
        a = a + 1.0
        b = b * 1.01 + a * 0.001
    np.testing.assert_allclose(out.numpy(), b + n, rtol=1e-5)


@pytest.mark.parametrize("shape", [(64, 16, 64), (192, 32, 320),
                                   (1024, 48, 1024), (64, 16, 4096)],
                         ids=["one_tile", "k32_n320", "k48", "n4096"])
def test_p2_plain_matches_float64_product(shape):
    """P2's plain version against numpy's float64 product, relative to the
    largest entry, at the shapes the kernel's tiles cut differently: one
    tile, two K steps with N a multiple of 64 and not of 128, three K
    steps, one row of tiles.  `test_torch_cuda.py` holds the kernel to the
    plain version on the same inputs."""
    m, k, n = shape
    rs = np.random.RandomState(m + k + n)
    a = rs.randn(m, k).astype(np.float32)
    b = rs.randn(k, n).astype(np.float32)
    got = pp.p2_dot(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = a.astype(np.float64) @ b.astype(np.float64)
    # Float32 sums over K in another order than numpy's float64.
    assert got.shape == (m, n)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-6


def test_p4_p5_ties():
    """P4: the lowest row wins an exact tie.  P5: tied rows sum, as the
    one-hot product does."""
    t = 1.0 + np.random.RandomState(2).rand(64, 128).astype(np.float32)
    t[40, 5] = t[9, 5] = 0.5
    m, row = pp.p4_min(torch.from_numpy(t))
    assert float(m[0, 5]) == 0.5 and int(row[0, 5]) == 9
    rs = np.random.RandomState(3)
    packed = rs.randint(1, 1 << 20, (64, 128)).astype(np.int32)
    packed[3, 7] = packed[50, 7] = 0
    attr = rs.randn(16, 64).astype(np.float32)
    got = pp.p5_onehot_gather(
        torch.from_numpy(packed),
        torch.from_numpy(packed.min(axis=0, keepdims=True)),
        torch.from_numpy(attr)).numpy()
    np.testing.assert_array_equal(got[:, 7], attr[:, 3] + attr[:, 50])
    np.testing.assert_array_equal(got[:, 8], attr[:, packed[:, 8].argmin()])


def _onehot(packed, attr):
    """numpy's one-hot product of P5, in float32."""
    m = packed.min(axis=0, keepdims=True)
    return m, attr @ (packed == m).astype(np.float32)


@pytest.mark.parametrize("shape,tie_rows", [
    ((512, 1024), (3, 500)), ((512, 200), (0, 511)), ((1024, 256), (5, 1000))],
    ids=["tie_far_apart", "ragged_columns", "rows_1024"])
def test_p5_ties_and_ragged_shapes(shape, tie_rows):
    """P5's wrapper against numpy's one-hot product: a two-way tie between
    rows far apart, R not a multiple of 128, and S = 1,024, which the wrapper
    refused while the kernel staged `attr` (768 rows at most).  On the CPU
    this runs the plain version; `test_torch_cuda.py` runs the kernel on the
    same shapes, where the rows cross its chunks and slabs."""
    s, r = shape
    rs = np.random.RandomState(9)
    packed = rs.randint(1, 1 << 20, (s, r)).astype(np.int32)
    a, b = tie_rows
    packed[a, r // 2] = packed[b, r // 2] = 0
    attr = rs.randn(16, s).astype(np.float32)
    m, want = _onehot(packed, attr)
    got = pp.p5_onehot_gather(torch.from_numpy(packed), torch.from_numpy(m),
                              torch.from_numpy(attr)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, r // 2], attr[:, a] + attr[:, b])


def _packed_key_min(t):
    """The reference's P4 in numpy (`tools/proto_mxu.py::p4_min_packed`):
    the row packed into the low 9 bits of t's bits, one int32 minimum per
    column -> (the key's value, its row)."""
    rows = np.arange(t.shape[0], dtype=np.int32)[:, None]
    packed = (t.view(np.int32) & ~np.int32(511)) | rows
    m = packed.min(axis=0)
    return (m & ~np.int32(511)).view(np.float32), m & 511


@pytest.mark.parametrize("nan_rows", [(0, 9), (5,), tuple(range(64))],
                         ids=["rows_0_and_9", "one_row", "all_rows"])
def test_p4_nan_never_wins(nan_rows):
    """P4's plain version orders NaN as the reference's packed key does:
    above every positive number, so a NaN never wins against a number and
    an all-NaN column gives row 0.  The data's values differ above the low 9
    bits, so the key's truncation decides nothing here: its row is the
    argmin and its value the minimum's, bits 9 and up."""
    rs = np.random.RandomState(4)
    t = (1.0 + rs.permutation(64 * 256).reshape(64, 256) / 512.0).astype(
        np.float32)
    t[list(nan_rows), 3] = np.nan
    t[list(nan_rows), 200] = np.nan
    want_t, want_row = _packed_key_min(t)
    m, row = pp.p4_min(torch.from_numpy(t))
    m, row = m.numpy().reshape(-1), row.numpy().reshape(-1)
    np.testing.assert_array_equal(row, want_row)
    # The port's value is the row's own, untruncated.
    np.testing.assert_array_equal(m.view(np.int32),
                                  t[row, np.arange(256)].view(np.int32))
    np.testing.assert_array_equal(m.view(np.int32) & ~511,
                                  want_t.view(np.int32))
    if len(nan_rows) == 64:
        assert np.isnan(m[3]) and row[3] == 0
    else:
        assert not np.isnan(m[3]) and row[3] not in nan_rows


@pytest.mark.parametrize("rows", [1, 8, 37])
def test_p3_matches_numpy_at_any_row_count(rows):
    """P3 against numpy's x * 2, bit for bit, at one row, the tool's eight
    and a count that fills no block of the kernel, on seeded normals with
    -0.0, the smallest subnormal, +-inf and the largest float (whose double
    is inf) among them.  `test_torch_cuda.py` holds the kernel to the plain
    version at these counts and at 2^21 rows."""
    rs = np.random.RandomState(100 + rows)
    x = rs.randn(rows, 128).astype(np.float32)
    specials = np.array([-0.0, np.float32(1.4e-45), np.inf, -np.inf,
                         np.finfo(np.float32).max], np.float32)
    idx = rs.permutation(x.size)[:specials.size]
    x.reshape(-1)[idx] = specials
    got = pp.p3_reshape(torch.from_numpy(x)).numpy()
    assert got.shape == (rows, 128) and got.dtype == np.float32
    with np.errstate(over="ignore"):  # the largest float doubles to inf
        want = x * 2
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_launch_refuses_an_integer_that_does_not_fit_its_slot():
    """P3's row count is bound as a 64-bit integer, and `_launch` refuses an
    integer that does not fit its ctypes slot before anything is built or
    launched (ctypes would pass 2^31 in a c_int as -2^31)."""
    import ctypes

    assert pp.SIGNATURES["brt_p3_reshape"][2] is ctypes.c_int64
    assert all(t is not ctypes.c_int for t in pp.SIGNATURES["brt_p3_reshape"])
    calls = []

    class Fn:
        argtypes = pp.SIGNATURES["brt_p2_dot"]

        def __call__(self, *args):
            calls.append(args)
            return 0

    before = spans.counter("p2.launches")
    with pytest.raises(ValueError, match="c_int"):
        pp._launch("p2", lambda: {"brt_p2_dot": Fn()}, "brt_p2_dot",
                   torch.device("cuda"), 0, 0, 0, 1 << 31, 64, 16)
    assert not calls and spans.counter("p2.launches") == before
    with pytest.raises(ValueError):
        pp._check_ints("brt_p4_min", pp.SIGNATURES["brt_p4_min"],
                       (0, 0, 0, -(1 << 31) - 1, 128))
    pp._check_ints("brt_p3_reshape", pp.SIGNATURES["brt_p3_reshape"],
                   (0, 0, (1 << 31) + 5))
    pp._check_ints("brt_p2_dot", pp.SIGNATURES["brt_p2_dot"],
                   (0, 0, 0, (1 << 31) - 1, 64, 16))
    with pytest.raises(ValueError):
        pp._check_ints("brt_v1_root_check",
                       vp.SIGNATURES["brt_v1_root_check"], (-1, 1))


# --- V1-V3: the tool's kernel factories at (256, 1024), 3 rounds -------------


def _inputs(vpu, dtype=np.float32):
    rs = np.random.RandomState(11)
    g = (rs.rand(vpu.S, 8) + 1.0).astype(dtype)
    r = rs.rand(8, vpu.R).astype(dtype)
    return g, r


def _reference(vpu, kernel, g, r):
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((1, vpu.R), jnp.float32),
        interpret=True)(jnp.asarray(g), jnp.asarray(r)))


def _clear10(t):
    """float32 with its low 10 mantissa bits cleared: the reference's key."""
    return (t.view(np.int32) & ~np.int32(1023)).view(np.float32)


def _v1(vpu):
    g, r = _inputs(vpu)
    want = _reference(vpu, vpu.sweep_kernel(jnp.float32), g, r)
    got = vp.v1_sweep(torch.from_numpy(g), torch.from_numpy(r), 3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _v2_f32(vpu):
    g, r = _inputs(vpu)
    want = _reference(vpu, vpu.fma_kernel(jnp.float32), g, r)
    got = vp.v2_fma(torch.from_numpy(g), torch.from_numpy(r), 3).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _v2_bf16(vpu):
    g, r = _inputs(vpu)
    tg = torch.from_numpy(g).to(torch.bfloat16)
    tr = torch.from_numpy(r).to(torch.bfloat16)
    want = _reference(vpu, vpu.fma_kernel(jnp.bfloat16),
                      jnp.asarray(g).astype(jnp.bfloat16),
                      jnp.asarray(r).astype(jnp.bfloat16))
    got = vp.v2_fma(tg, tr, 3).numpy()
    # bfloat16 rounds after every operation, in another place in each
    # framework.
    np.testing.assert_allclose(got, want, rtol=5e-2)


def _v3(vpu, variant, ports=None):
    """The reference's `variant` against each of the port's `ports` forms
    (the same name unless given: "prod" and "k1" are both held against the
    reference's "prod")."""
    g, r = _inputs(vpu)
    want = _reference(vpu, vpu.sweep_full_dep(variant), g, r)
    for port in ports or (variant,):
        t, idx = vp.v3_sweep(torch.from_numpy(g), torch.from_numpy(r), 3,
                             port)
        _v3_check(g, r, variant, want, t, idx)


def _v3_check(g, r, variant, want, t, idx):
    assert idx.dtype == torch.int32
    # A ray that hits nothing is NaN on both sides (20 of the 1,024 "prod"
    # rays), and -1 in the port's index.
    miss = np.isnan(want)
    assert miss.mean() < 0.05
    np.testing.assert_array_equal(idx.numpy() == -1, miss)
    # One step of the reference's 22-bit key is 2^-13 relative; the roots
    # are differences of O(1) terms, each rounded in float32 (atol).
    np.testing.assert_allclose(_clear10(t.numpy()), want, rtol=2.5e-4,
                               atol=2e-6)
    # The index against the argmin of the plain planes, made here in
    # float64 from the same inputs.
    g64, r64 = g.astype(np.float64), r.astype(np.float64)
    oc = [r64[k][None, :] - g64[:, k][:, None] for k in range(3)]
    hb = sum(oc[k] * r64[3 + k][None, :] for k in range(3))
    disc = hb * hb - (sum(c * c for c in oc) - g64[:, 3][:, None])
    with np.errstate(invalid="ignore"):
        sq = disc if variant == "nosqrt" else np.sqrt(disc)
        rn = -hb - sq
        tn = np.where(rn > 1e-3, rn, sq - hb)
        planes = np.where(tn > 1e-3, tn, np.inf)
    same = (idx.numpy() == planes.argmin(axis=0))[~miss]
    assert same.mean() >= 0.995, f"{(~same).sum()} columns differ"


@pytest.mark.parametrize("case", [
    _v1, _v2_f32, _v2_bf16,
    functools.partial(_v3, variant="prod", ports=("prod", "k1")),
    functools.partial(_v3, variant="nosqrt")],
    ids=["v1", "v2_f32", "v2_bf16", "v3_prod", "v3_nosqrt"])
def test_rate_probe_matches_reference(monkeypatch, vpu, case):
    monkeypatch.setattr(vpu, "ITERS", 3)
    case(vpu)


def _v1_edges(n_rays):
    """(g [64, 8], r [8, n_rays]) with small dyadic values, so that every
    operation before the root is exact and no contraction can change a
    bit; every ray along +z, the table behind the rays but for sphere 0 or
    1.  Rays 4k: tangent to sphere 0 (disc == 0, t = 2 taken: 3.0 out);
    4k + 1: beside it (disc < 0: 4.0 out); 4k + 2: at the centre of sphere
    1, whose r^2 = 2^-130 makes disc a positive denormal (both roots under
    t_min: 4.0 out); 4k + 3: through sphere 0 (disc = 0.75)."""
    rs = np.random.RandomState(29)
    g = np.zeros((64, 8), np.float32)
    g[:, :2] = rs.randint(-16, 17, (64, 2)) / 8.0
    g[:, 2] = -20.0 - rs.randint(0, 17, 64) / 8.0
    g[:, 3] = rs.randint(1, 65, 64) / 64.0
    g[0, :4] = (0.0, 0.0, 2.0, 1.0)
    g[1, :4] = (5.0, 5.0, 0.5, 2.0 ** -130)
    r = np.zeros((8, n_rays), np.float32)
    r[5] = 1.0
    for k, origin in enumerate(((1.0, 0.0, 0.0), (3.0, 0.0, 0.0),
                                (5.0, 5.0, 0.5), (0.5, 0.0, 0.0))):
        r[:3, k::4] = np.asarray(origin, np.float32)[:, None]
    return g, r


def test_v1_tangent_negative_and_denormal_disc(monkeypatch, vpu):
    """V1's plain version against the reference's `sweep_kernel` (interpret
    mode) where the root's rule decides: a tangent ray takes t = -hb
    (sqrt(0) = 0), a negative disc and a positive denormal disc give the
    miss value 3.0.  The CUDA kernel is held to the same plain version bit
    for bit on these inputs in `test_torch_cuda.py`."""
    g, r = _v1_edges(256)
    monkeypatch.setattr(vpu, "ITERS", 3)
    monkeypatch.setattr(vpu, "R", 256)
    want = _reference(vpu, vpu.sweep_kernel(jnp.float32), g, r)
    got = vp.v1_sweep(torch.from_numpy(g), torch.from_numpy(r), 3).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got[0, 0::4], 3.0)
    np.testing.assert_array_equal(got[0, 1::4], 4.0)
    np.testing.assert_array_equal(got[0, 2::4], 4.0)
    np.testing.assert_array_equal(
        got[0, 3::4], np.float32(1.0) + (np.float32(2.0)
                                         - np.sqrt(np.float32(0.75))))


def test_v3_variants_agree_where_they_must():
    """The plain path gives "smem" and "k1" "prod"'s formula, bit for bit
    (on the card `test_torch_cuda.py` holds the three kernels to one
    another); "nobranch" differs from "prod" only in how the root is
    rounded; a ray that hits nothing gives (NaN, -1)."""
    rs = np.random.RandomState(5)
    g = torch.from_numpy((rs.rand(64, 8) + 1.0).astype(np.float32))
    r = torch.from_numpy(rs.rand(8, 256).astype(np.float32))
    t, idx = vp.v3_sweep(g, r, 2, "prod")
    for variant in ("smem", "k1"):
        t2, idx2 = vp.v3_sweep(g, r, 2, variant)
        assert torch.equal(t2.view(torch.int32), t.view(torch.int32))
        assert torch.equal(idx, idx2) and bool((idx >= 0).any())
    t3, idx3 = vp.v3_sweep(g, r, 2, "nobranch")
    # sqrt(disc) against disc * rsqrt(disc): an ulp of the O(1) root.
    torch.testing.assert_close(t3, t, rtol=1e-5, atol=1e-6, equal_nan=True)
    assert float((idx3 != idx).float().mean()) <= 0.005
    far = g.clone()
    far[:, :3] += 1e3
    away = r.clone()
    away[3:6] = -away[3:6] - 0.1
    t, idx = vp.v3_sweep(far, away, 2)
    assert bool(torch.isnan(t).all()) and bool((idx == -1).all())


# --- what the wrappers refuse -------------------------------------------------


def _bad_p1():
    return [lambda: pp.p1_while(torch.zeros(8, 128, dtype=torch.float64)),
            lambda: pp.p1_while(torch.zeros(4, 128)),
            lambda: pp.p1_while(torch.zeros(128, 8).T),
            lambda: pp.p1_while(np.zeros((8, 128), np.float32))]


def _bad_p2():
    return [lambda: pp.p2_dot(torch.zeros(64, 16).half(), torch.zeros(16, 64)),
            lambda: pp.p2_dot(torch.zeros(60, 16), torch.zeros(16, 64)),
            lambda: pp.p2_dot(torch.zeros(64, 16), torch.zeros(32, 64)),
            lambda: pp.p2_dot(torch.zeros(16, 64).T, torch.zeros(16, 64))]


def _bad_p3():
    return [lambda: pp.p3_reshape(torch.zeros(8, 128, dtype=torch.int32)),
            lambda: pp.p3_reshape(torch.zeros(8, 64)),
            lambda: pp.p3_reshape(torch.zeros(8, 256)[:, ::2])]


def _bad_p4():
    return [lambda: pp.p4_min(torch.zeros(8, 128, dtype=torch.float64)),
            lambda: pp.p4_min(torch.zeros(8, 100)),
            lambda: pp.p4_min(torch.zeros(128, 8).T)]


def _bad_p5():
    p = torch.zeros(8, 128, dtype=torch.int32)
    m = torch.zeros(1, 128, dtype=torch.int32)
    a = torch.zeros(16, 8)
    return [lambda: pp.p5_onehot_gather(p.long(), m, a),
            lambda: pp.p5_onehot_gather(p, m[0], a),
            lambda: pp.p5_onehot_gather(p, m, torch.zeros(8, 8)),
            lambda: pp.p5_onehot_gather(p, m, torch.zeros(8, 16).T),
            lambda: pp.p5_onehot_gather(
                torch.zeros(0, 128, dtype=torch.int32), m,
                torch.zeros(16, 0))]


def _bad_v(fn, **kw):
    g, r = torch.ones(4, 8), torch.ones(8, 16)
    return [lambda: fn(g.double(), r, 1, **kw),
            lambda: fn(g[:, :4], r, 1, **kw),
            lambda: fn(g, torch.ones(16, 8).T, 1, **kw),
            lambda: fn(g, r, -1, **kw)]


def _bad_v2():
    return _bad_v(vp.v2_fma) + [
        lambda: vp.v2_fma(torch.ones(4, 8).bfloat16(),
                          torch.ones(8, 15).bfloat16(), 1),
        lambda: vp.v2_fma(torch.ones(4, 8).bfloat16(), torch.ones(8, 16), 1)]


def _bad_v3():
    return _bad_v(vp.v3_sweep) + [
        lambda: vp.v3_sweep(torch.ones(4, 8), torch.ones(8, 16), 0),
        lambda: vp.v3_sweep(torch.ones(4, 8), torch.ones(8, 16), 1, "fast")]


@pytest.mark.parametrize("cases", [
    _bad_p1, _bad_p2, _bad_p3, _bad_p4, _bad_p5,
    functools.partial(_bad_v, vp.v1_sweep), _bad_v2, _bad_v3],
    ids=["p1", "p2", "p3", "p4", "p5", "v1", "v2", "v3"])
def test_wrapper_refuses_wrong_operands(cases):
    """A wrong dtype, shape or a non-contiguous tensor raises; nothing is
    converted behind the caller's back."""
    for call in cases():
        with pytest.raises((TypeError, ValueError)):
            call()
