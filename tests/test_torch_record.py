"""K2's plain twin (`kernels/record.py::render_record_plain`) against the JAX
package's TPU kernel `render_pallas(..., with_residuals=True,
record_second=True)`, run as its own tests run it (`interpret=True`), and
the recorder's contract.  The CUDA kernel's own tests are in
test_torch_cuda.py.

Bounds (48x32, 2 spp, depth 3, frame 1):
  * image: parity.INTERPRET (median <= 1e-6, <= 0.05% of pixels > 1e-4),
    as tests/test_mxu.py: twin and TPU kernel run the same expanded
    quadratic in float32 on one CPU;
  * residuals: identical on >= 99.5% of entries (a last-ulp difference may
    flip a near-tie or a grazing scatter), and all of them on config1.
"""

import numpy as np
import pytest
import torch

from bevy_raytrace_tpu import RenderConfig as JConfig
from bevy_raytrace_tpu import scenes as jsc
from bevy_raytrace_tpu.core.types import make_scene as j_make_scene
from bevy_raytrace_tpu.kernels.pallas_render import render_pallas
from bevy_raytrace_tpu_torch import RenderConfig
from bevy_raytrace_tpu_torch import set_default_device
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch.core.types import make_scene
from bevy_raytrace_tpu_torch.interop import (
    camera_from_reference,
    residuals_from_reference,
    scene_from_reference,
)
from bevy_raytrace_tpu_torch.inverse import replay_image
from bevy_raytrace_tpu_torch.kernels import record as k2
from bevy_raytrace_tpu_torch.kernels.clusters import cluster_scene
from bevy_raytrace_tpu_torch.parity import INTERPRET, compare
from bevy_raytrace_tpu_torch.utils import spans

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

KW = dict(width=48, height=32, samples_per_pixel=2, max_depth=3)

# A small scene with every material: ground, Lambertian, fuzzed metal,
# glass and a hollow glass shell (negative radius), made from a seed.
_rng = np.random.default_rng(11)
ALL_MATERIALS = dict(
    centers=np.array([[0.0, -100.5, -1.0], [0.0, 0.0, -1.0],
                      [-1.0, 0.0, -1.0], [-1.0, 0.0, -1.0],
                      [1.0, 0.0, -1.0]], np.float32)
    + np.r_[[[0, 0, 0]], _rng.uniform(-0.05, 0.05, (4, 3))].astype(np.float32),
    radii=np.array([100.0, 0.5, 0.5, -0.45, 0.5], np.float32),
    material_id=np.array([0, 1, 2, 2, 3], np.int32),
    albedo=np.c_[_rng.uniform(0.2, 0.9, (4, 3))].astype(np.float32),
    kind=np.array([0, 0, 2, 1], np.int32),
    fuzz=np.array([0.0, 0.0, 0.0, 0.3], np.float32),
    ior=np.array([1.0, 1.0, 1.5, 1.0], np.float32),
)

SCENES = {
    "config1": (lambda: jsc.baseline_config1_scene()[0],
                jsc.baseline_config1_camera, 1.0),
    "config2": (lambda: jsc.baseline_config2_scene()[0],
                jsc.baseline_config2_camera, 0.995),
    "all_materials": (lambda: j_make_scene(**ALL_MATERIALS),
                      jsc.baseline_config2_camera, 0.995),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_twin_matches_tpu_kernel(name):
    build, camera, min_equal = SCENES[name]
    jscene = build()
    jcam = camera(KW["width"] / KW["height"])
    cfg = RenderConfig(**KW)
    want_img, want_res, want_res2 = render_pallas(
        jscene, jcam, JConfig(**KW), 1, interpret=True, with_residuals=True,
        record_second=True)
    before = spans.counter("k2.launches")
    img, res, res2 = k2.render_record_plain(
        scene_from_reference(jscene), camera_from_reference(jcam), cfg, 1,
        record_second=True)
    assert spans.counter("k2.launches") == before  # the twin is no launch
    stats = compare(img.numpy(), np.asarray(want_img), INTERPRET)
    assert stats["ok"], stats
    for got, want in ((res, want_res), (res2, want_res2)):
        want = residuals_from_reference(want, cfg.num_pixels)
        assert got.dtype == want.dtype == torch.int16
        assert got.shape == (2, 3, cfg.num_pixels)
        assert float((got == want).float().mean()) >= min_equal


def test_tangent_ray_hits_as_in_the_tpu_kernel():
    """A pinhole camera with no field of view sends every ray from (1, 0, 0)
    along (0, 0, -1), tangent to the sphere at (0, 0, -5) of radius 1: in the
    expanded quadratic half_b = -5, cq = 25 and disc == 0 exactly.  The TPU
    kernel records that tangency as a hit of the first bounce, and so does
    the twin (the CUDA kernel's guard is disc >= 0 for this reason)."""
    from bevy_raytrace_tpu.core.camera import Camera as JCamera
    import jax.numpy as jnp

    kw = dict(width=16, height=8, samples_per_pixel=2, max_depth=3)
    vec = lambda *v: jnp.asarray(v, jnp.float32)  # noqa: E731
    zero = jnp.float32(0.0)
    jcam = JCamera(origin=vec(1, 0, 0), u=vec(1, 0, 0), v=vec(0, 1, 0),
                   w=vec(0, 0, 1), half_width=zero, half_height=zero,
                   lens_radius=zero, focus_dist=jnp.float32(1.0))
    jscene = j_make_scene(centers=[[0.0, 0.0, -5.0]], radii=[1.0],
                          material_id=[0], albedo=[[0.5, 0.6, 0.7]],
                          kind=[0], fuzz=[0.0], ior=[1.5])
    _, want_res, want_res2 = render_pallas(
        jscene, jcam, JConfig(**kw), 1, interpret=True, with_residuals=True,
        record_second=True)
    cfg = RenderConfig(**kw)
    _, res, res2 = k2.render_record_plain(
        scene_from_reference(jscene), camera_from_reference(jcam), cfg, 1,
        record_second=True)
    want_res = residuals_from_reference(want_res, cfg.num_pixels)
    assert bool((want_res[:, 0] == 0).all()), "the TPU kernel missed"
    assert torch.equal(res, want_res)
    assert torch.equal(res2, residuals_from_reference(want_res2,
                                                      cfg.num_pixels))


@pytest.mark.parametrize("edge", [0.0, 0.01])
def test_replay_reconstructs_the_recorded_image(edge):
    """The residuals are a complete checkpoint: the torch replay of them
    (no sphere search) gives the recorder's image back (5e-5, the JAX
    package's bound in tests/test_fast_grad.py)."""
    cfg = RenderConfig(**KW, edge_softness=edge)
    scene, _ = tsc.baseline_config2_scene()
    cam = tsc.baseline_config2_camera(cfg.aspect)
    img, res, res2 = k2.render_record(scene, cam, cfg, 0,
                                      record_second=edge > 0)
    assert (res2 is None) == (edge == 0)
    rep = replay_image(scene, cam, cfg, res, 0, res2=res2)
    np.testing.assert_allclose(rep.detach().numpy(), img.numpy(), atol=5e-5)


def test_sample_chunks_record_the_same_paths():
    """sample_base offsets the RNG sample ids: samples [2, 4) recorded alone
    are samples [2, 4) of the full recording, residual for residual."""
    cfg = RenderConfig(**{**KW, "samples_per_pixel": 4})
    scene, _ = tsc.baseline_config2_scene()
    cam = tsc.baseline_config2_camera(cfg.aspect)
    img, res, res2 = k2.render_record(scene, cam, cfg, 2, record_second=True)
    half = cfg.replace(samples_per_pixel=2)
    img_a, res_a, _ = k2.render_record(scene, cam, half, 2)
    img_b, res_b, res2_b = k2.render_record(scene, cam, half, 2,
                                            sample_base=2, record_second=True)
    torch.testing.assert_close(res[:2], res_a, rtol=0, atol=0)
    torch.testing.assert_close(res[2:], res_b, rtol=0, atol=0)
    torch.testing.assert_close(res2[2:], res2_b, rtol=0, atol=0)
    np.testing.assert_allclose(((img_a + img_b) / 2).numpy(), img.numpy(),
                               atol=1e-6)
    value, no_res, no_res2 = k2.record_frame(
        *k2._operands(scene, cam), cfg, 2, with_residuals=False)
    assert no_res is None and no_res2 is None
    torch.testing.assert_close(value, img, rtol=0, atol=0)


def test_int32_residuals_above_int16_slots():
    """Residuals are int16 up to 32,767 spheres (pallas_render.py:723) and
    int32 above: a winner index past 32,767 must survive the store."""
    assert k2.residual_dtype(32767) == torch.int16
    assert k2.residual_dtype(32768) == torch.int32
    n = 32769
    centers = np.zeros((n, 3), np.float32)
    centers[:, 2] = -1000.0  # out of view, except the last sphere
    centers[-1] = (0.0, 0.0, -1.0)
    scene = make_scene(centers, np.full(n, 0.5, np.float32),
                       np.zeros(n, np.int32), [[0.5, 0.5, 0.5]], [0], [0.0],
                       [1.0])
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1, max_depth=1)
    _, res, _ = k2.render_record(scene, tsc.baseline_config1_camera(2.0), cfg)
    assert res.dtype == torch.int32
    assert int(res.max()) == n - 1


def test_recorder_rejects_what_it_does_not_take():
    cfg = RenderConfig(**KW)
    scene, _ = tsc.baseline_config1_scene()
    cam = tsc.baseline_config1_camera(cfg.aspect)
    for render in (k2.render_record, k2.render_record_plain):
        with pytest.raises(TypeError, match="ClusterPlan"):
            render(scene, cam, cfg, clusters=object())
        # A real plan (one cluster per sphere) records what no plan does.
        plan = cluster_scene(scene, cluster_size=1)
        for a, b in zip(render(scene, cam, cfg, record_second=True),
                        render(scene, cam, cfg, record_second=True,
                               clusters=plan)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        # Stripe mode takes pixel_base with num_local, inside the frame.
        with pytest.raises(ValueError, match="num_local"):
            render(scene, cam, cfg, pixel_base=0)
        for base, local in ((0, 0), (-1, 64), (cfg.num_pixels - 63, 64)):
            with pytest.raises(ValueError, match="inside the frame"):
                render(scene, cam, cfg, pixel_base=base, num_local=local)
    table, cam16 = k2._operands(scene, cam)
    with pytest.raises(ValueError, match="record_second"):
        k2.record_frame(table, cam16, cfg, with_residuals=False,
                        record_second=True)
    with pytest.raises(TypeError, match="float32"):
        k2.record_frame(table.double(), cam16, cfg)
    with pytest.raises(ValueError, match="shape"):
        k2.record_frame(table[:, :10].contiguous(), cam16, cfg)
    with pytest.raises(ValueError, match="on meta"):
        k2.record_frame(table.to("meta"), cam16, cfg)
    with pytest.raises(ValueError, match="sample_base"):
        k2.record_frame(table, cam16, cfg, sample_base=-1)
