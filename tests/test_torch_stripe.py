"""Stripe mode (`pixel_base`, `num_local`) of the port's kernels, on their
plain twins: stripes compose into the full frame, and a stripe agrees with
the JAX package's stripe.

RNG counters and pixel coordinates key on ABSOLUTE pixel ids, so:
  * two half stripes of K2's, K4's and K1's twins equal the slices of the
    full render BIT FOR BIT, image and residuals (the JAX package's
    tests/test_fast_grad.py:250-272);
  * K3's twin on the two stripes sums to the full cotangent up to float32
    summation order: rtol 1e-4, atol 1e-5 of max-abs (tests/test_shard_grad.py's
    bound for the same sum across devices);
  * a stripe of the JAX `render_pallas(num_local=...)` and
    `replay_grad(num_local=...)` (interpret mode) against the port's: image
    under parity.INTERPRET and residuals on >= 99.5% of entries as in
    test_torch_record.py, cotangents under parity.grad_close at rtol 2e-3 as
    in test_torch_fast_grad.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bevy_raytrace_tpu import RenderConfig as JConfig
from bevy_raytrace_tpu import scenes as jsc
from bevy_raytrace_tpu.core.geometry import sphere_table as j_sphere_table
from bevy_raytrace_tpu.kernels.pallas_render import render_pallas
from bevy_raytrace_tpu.kernels.replay_grad import replay_grad as j_replay_grad
from bevy_raytrace_tpu_torch import RenderConfig
from bevy_raytrace_tpu_torch import set_default_device
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch.interop import (
    camera_from_reference,
    residuals_from_reference,
    scene_from_reference,
)
from bevy_raytrace_tpu_torch.kernels import record as k2
from bevy_raytrace_tpu_torch.kernels import render_lanes as k1
from bevy_raytrace_tpu_torch.kernels import replay_grad as k3
from bevy_raytrace_tpu_torch.kernels import sweep_record as k4
from bevy_raytrace_tpu_torch.parity import INTERPRET, compare, grad_close
from bevy_raytrace_tpu_torch.shard import Mesh, render_mxu_sharded

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

KW = dict(width=64, height=32, samples_per_pixel=2, max_depth=3)
N = KW["width"] * KW["height"]
STRIPES = ((0, N // 2), (N // 2, N // 2))


def _config2(edge=0.0):
    cfg = RenderConfig(**KW, edge_softness=edge)
    scene, _ = tsc.baseline_config2_scene()
    return scene, tsc.baseline_config2_camera(cfg.aspect), cfg


def _k2(table, cam16, cfg, **stripe):
    return k2.record_frame(table, cam16, cfg, 1, record_second=True, **stripe)


def _k4(table, cam16, cfg, **stripe):
    return k4.sweep_record_frame(table, cam16, cfg, 1, record_second=True,
                                 **stripe)


@pytest.mark.parametrize("record", [_k2, _k4], ids=["k2", "k4"])
def test_recorder_stripes_compose_bit_for_bit(record):
    scene, cam, cfg = _config2()
    table, cam16 = k2._operands(scene, cam)
    img, res, res2 = record(table, cam16, cfg)
    flat = img.reshape(N, 3)
    for base, local in STRIPES:
        img_s, res_s, res2_s = record(table, cam16, cfg, pixel_base=base,
                                      num_local=local)
        assert img_s.shape == (local, 3) and res_s.shape == (2, 3, local)
        assert torch.equal(img_s, flat[base:base + local])
        assert torch.equal(res_s, res[:, :, base:base + local])
        assert torch.equal(res2_s, res2[:, :, base:base + local])
    # A stripe from pixel 0 needs no pixel_base (the reference's default).
    img_0, _, _ = record(table, cam16, cfg, num_local=128)
    assert torch.equal(img_0, flat[:128])


def _fake_mesh(chip, chips=2):
    """A rank's view of a `chips`-wide mesh with no process group behind
    it: enough for the stripe arithmetic, which does no collective."""
    return Mesh(hosts=1, chips=chips, host=0, chip=chip, world_size=chips,
                group=None, device=torch.device("cpu"))


@pytest.mark.parametrize("balance", [False, True])
def test_k1_stripes_compose_bit_for_bit(balance):
    """K1 needs no stripe mode: it renders the absolute ids it is given.
    `render_mxu_sharded` on each of two ranks gives the slices of
    `render_mxu`, with or without the rank-local cost balancing."""
    scene, cam, cfg = _config2()
    flat = k1.render_mxu(scene, cam, cfg, 1).reshape(N, 3)
    for chip, (base, local) in enumerate(STRIPES):
        got = render_mxu_sharded(scene, cam, cfg, _fake_mesh(chip), 1,
                                 balance=balance)
        assert got.shape == (local, 3)
        assert torch.equal(got, flat[base:base + local])


@pytest.mark.parametrize("edge", [0.0, 0.01])
def test_k3_stripes_sum_to_the_full_cotangent(edge):
    scene, cam, cfg = _config2(edge)
    table, cam16 = k2._operands(scene, cam)
    _, res, res2 = k2.record_frame(table, cam16, cfg, 1,
                                   record_second=edge > 0)
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (N, 3)).astype(np.float32))
    want_tbl, want_cam = k3.replay_grad(table, cam16, cfg, res,
                                        g.reshape(cfg.height, cfg.width, 3),
                                        1, res2=res2)
    got_tbl, got_cam = torch.zeros_like(want_tbl), torch.zeros_like(want_cam)
    for base, local in STRIPES:
        sl = slice(base, base + local)
        d_tbl, d_cam = k3.replay_grad(
            table, cam16, cfg, res[:, :, sl].contiguous(),
            g[sl].contiguous(), 1,
            res2=None if res2 is None else res2[:, :, sl].contiguous(),
            pixel_base=base, num_local=local)
        got_tbl, got_cam = got_tbl + d_tbl, got_cam + d_cam
    assert float(want_tbl.abs().max()) > 0.0
    for got, want in ((got_tbl, want_tbl), (got_cam, want_cam)):
        np.testing.assert_allclose(
            got.numpy(), want.numpy(), rtol=1e-4,
            atol=1e-5 * float(want.abs().max()))


def test_stripe_matches_the_jax_stripe():
    """The second half stripe, recorded and replayed by the JAX package's
    kernels in stripe mode, against the port's twins on the same stripe."""
    kw = {**KW, "edge_softness": 0.01}
    base, local = STRIPES[1]
    jscene, _ = jsc.baseline_config2_scene()
    jcam = jsc.baseline_config2_camera(kw["width"] / kw["height"])
    jcfg, cfg = JConfig(**kw), RenderConfig(**kw)
    want_img, jres, jres2 = render_pallas(
        jscene, jcam, jcfg, 1, interpret=True, with_residuals=True,
        record_second=True, pixel_base=jnp.uint32(base), num_local=local)
    scene, cam = scene_from_reference(jscene), camera_from_reference(jcam)
    table, cam16 = k2._operands(scene, cam)
    img, res, res2 = k2.render_record(scene, cam, cfg, 1, record_second=True,
                                      pixel_base=base, num_local=local)
    stats = compare(img.numpy(), np.asarray(want_img), INTERPRET)
    assert stats["ok"], stats
    # The JAX stripe's residuals are padded to whole tiles: interop cuts
    # [spp, depth, p_pad_local] to the stripe.
    carried = [residuals_from_reference(r, local) for r in (jres, jres2)]
    for got, want in zip((res, res2), carried):
        assert got.shape == want.shape == (2, 3, local)
        assert float((got == want).float().mean()) >= 0.995

    g = np.random.default_rng(3).standard_normal((local, 3)).astype(np.float32)
    jtable = j_sphere_table(jscene.centers, jscene.radii, jscene.materials,
                            jscene.material_id)
    want_tbl, want_cam = j_replay_grad(
        jtable, jcam, jcfg, jres, jnp.asarray(g), 1, interpret=True,
        res2=jres2, pixel_base=jnp.uint32(base), num_local=local)
    got_tbl, got_cam = k3.replay_grad(
        table, cam16, cfg, carried[0], torch.from_numpy(g), 1,
        res2=carried[1], pixel_base=base, num_local=local)
    glob = max(float(np.abs(want_tbl).max()), float(np.abs(want_cam).max()))
    assert glob > 0.0
    for got, want in ((got_tbl, want_tbl), (got_cam, want_cam)):
        stats = grad_close(got.numpy(), np.asarray(want), 2e-3, glob)
        assert stats["ok"], stats
