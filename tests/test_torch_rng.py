"""PCG4D and the samplers of the port against the JAX package.

The counters are integer work, so the hash and the uniforms must be
bit-equal; the samplers go through sin/cos/sqrt/cbrt, whose last ulp differs
between torch's and XLA's CPU math, so they are held at 1e-6."""

import numpy as np
import jax.numpy as jnp
import torch

from bevy_raytrace_tpu.rng import pcg as jpcg
from bevy_raytrace_tpu_torch.rng import pcg as tpcg

torch.set_num_threads(2)

N = 10_000


def _counters(seed):
    rng = np.random.default_rng(seed)
    cols = []
    for _ in range(4):
        c = rng.integers(0, 2**32, N, dtype=np.uint64)
        c[:64] = 2**32 - 1 - np.arange(64)  # the top of the range
        c[64:128] = np.arange(64)  # and the bottom
        rng.shuffle(c)
        cols.append(c.astype(np.uint32))
    return cols


def test_pcg4d_bit_equal():
    cols = _counters(0)
    want = jpcg.pcg4d(*(jnp.asarray(c) for c in cols))
    got = tpcg.pcg4d(*(torch.from_numpy(c.astype(np.int64)) for c in cols))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32),
                                      np.asarray(w))


def test_uniform4_bit_equal_with_scalar_streams():
    """Tensor pixel/sample ids with python-int stream and seed, as the
    renderers call it (including a stream and seed above 2^31)."""
    pix, smp, _, _ = _counters(1)
    for stream, seed in [(0, 0), (5, 123), (0x9E3779B9, 0xFFFFFFFF)]:
        want = jpcg.uniform4(jnp.asarray(pix), jnp.asarray(smp), stream, seed)
        got = tpcg.uniform4(torch.from_numpy(pix.astype(np.int64)),
                            torch.from_numpy(smp.astype(np.int64)),
                            stream, seed)
        for w, g in zip(want, got):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_samplers_match():
    rng = np.random.default_rng(2)
    u = rng.random((3, N)).astype(np.float32)
    ju = [jnp.asarray(x) for x in u]
    tu = [torch.from_numpy(x) for x in u]
    np.testing.assert_allclose(tpcg.random_unit_vector(*tu[:2]).numpy(),
                               np.asarray(jpcg.random_unit_vector(*ju[:2])),
                               atol=1e-6)
    np.testing.assert_allclose(tpcg.random_in_unit_sphere(*tu).numpy(),
                               np.asarray(jpcg.random_in_unit_sphere(*ju)),
                               atol=1e-6)
    for g, w in zip(tpcg.random_in_unit_disk(*tu[:2]),
                    jpcg.random_in_unit_disk(*ju[:2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
