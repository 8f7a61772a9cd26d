"""K4's plain twin (`kernels/sweep_record.py`) against the JAX package's TPU
kernel `render_sweep_record`, run as its own tests run it
(`interpret=True`), and `make_fast_renderer(forward="sweep")` against the
JAX one.  The CUDA kernel's own tests are in test_torch_cuda.py.

Bounds (64x32, 2 spp, depth 3, frame 1):
  * image: parity.COMPILED (median <= 1e-5, <= 2% of pixels > 1e-2, |bias|
    <= 5e-4): the TPU kernel fetches the winner's row through three bf16
    limbs and floors pixel ids in float32, the twin indexes;
  * residuals: int16, identical on config1 and on >= 99.5% of entries
    elsewhere: the TPU kernel breaks near-ties between spheres on a packed
    key (t truncated to 22 bits | index), the port on the full float32 t.
    Measured here: identical on every entry of config1, config2 and the
    all-materials scene, res and res2; 99.98% on rtiow_final(grid=2), 20
    spheres (2 of 12,288 entries each);
  * replay: the twin's residuals reconstruct its image to 5e-5
    (tests/test_fast_grad.py:197-219's bound);
  * gradients of forward="sweep" against the JAX package's, on config1:
    rtol 5e-3, atol 3e-4 of max-abs (tests/test_fast_grad.py:222-238).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bevy_raytrace_tpu import RenderConfig as JConfig
from bevy_raytrace_tpu import scenes as jsc
from bevy_raytrace_tpu.core.types import make_scene as j_make_scene
from bevy_raytrace_tpu.inverse import make_fast_renderer as j_fast
from bevy_raytrace_tpu.kernels.sweep_record import (
    render_sweep_record as j_sweep_record,
)
from bevy_raytrace_tpu_torch import RenderConfig
from bevy_raytrace_tpu_torch import set_default_device
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch.interop import (
    camera_from_reference,
    residuals_from_reference,
    scene_from_reference,
)
from bevy_raytrace_tpu_torch.inverse import make_fast_renderer, replay_image
from bevy_raytrace_tpu_torch.kernels import record as k2
from bevy_raytrace_tpu_torch.kernels import sweep_record as k4
from bevy_raytrace_tpu_torch.parity import COMPILED, compare

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

KW = dict(width=64, height=32, samples_per_pixel=2, max_depth=3)

# Every material, made from a seed (tests/test_torch_record.py's scene).
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
    "rtiow_small": (lambda: jsc.rtiow_final_scene(0, grid=2)[0],
                    jsc.rtiow_final_camera, 0.995),
}


@pytest.mark.parametrize("second", [False, True], ids=["res", "res_res2"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_twin_matches_tpu_kernel(name, second):
    build, camera, min_equal = SCENES[name]
    jscene = build()
    jcam = camera(KW["width"] / KW["height"])
    cfg = RenderConfig(**KW)
    want = j_sweep_record(jscene, jcam, JConfig(**KW), 1, interpret=True,
                          record_second=second)
    scene, cam = scene_from_reference(jscene), camera_from_reference(jcam)
    before = k4.sweep_record_frame.launches
    got = k4.render_sweep_record(scene, cam, cfg, 1, record_second=second)
    assert k4.sweep_record_frame.launches == before  # the twin is no launch
    assert len(got) == len(want) == (3 if second else 2)
    stats = compare(got[0].numpy(), np.asarray(want[0]), COMPILED)
    assert stats["ok"], stats
    for got_res, want_res in zip(got[1:], want[1:]):
        want_res = residuals_from_reference(want_res, cfg.num_pixels)
        assert got_res.dtype == want_res.dtype == torch.int16
        assert got_res.shape == (2, 3, cfg.num_pixels)
        assert float((got_res == want_res).float().mean()) >= min_equal
    # The TPU kernel's residuals, carried across, replay to the port's image.
    edge_cfg = cfg.replace(edge_softness=0.01 if second else 0.0)
    res = [residuals_from_reference(r, cfg.num_pixels) for r in want[1:]]
    rep = replay_image(scene, cam, edge_cfg, res[0], 1,
                       res2=res[1] if second else None)
    carried = compare(rep.detach().numpy(), got[0].numpy(), COMPILED)
    assert carried["ok"], carried


@pytest.mark.parametrize("edge", [0.0, 0.01])
def test_replay_reconstructs_the_recorded_image(edge):
    """K4's residuals are a complete checkpoint: the torch replay of them
    (no sphere search) gives the recorder's image back."""
    cfg = RenderConfig(**KW, edge_softness=edge)
    scene, _ = tsc.baseline_config2_scene()
    cam = tsc.baseline_config2_camera(cfg.aspect)
    img, res, res2 = k4.sweep_record_frame(*k2._operands(scene, cam), cfg, 0,
                                           record_second=edge > 0)
    assert (res2 is None) == (edge == 0)
    rep = replay_image(scene, cam, cfg, res, 0, res2=res2)
    np.testing.assert_allclose(rep.detach().numpy(), img.numpy(), atol=5e-5)


def test_dead_paths_record_minus_one_and_samples_offset():
    """Every bounce after a path's end holds -1 (K3 reads every entry), a
    recorded runner-up implies a recorded winner, and sample_base offsets
    the RNG sample ids."""
    cfg = RenderConfig(**{**KW, "samples_per_pixel": 4, "max_depth": 5})
    scene, _ = tsc.baseline_config2_scene()
    cam = tsc.baseline_config2_camera(cfg.aspect)
    img, res, res2 = k4.render_sweep_record(scene, cam, cfg, 2,
                                            record_second=True)
    dead = torch.cummax((res < 0).int(), dim=1).values.bool()
    assert bool((res[dead] == -1).all()) and bool(dead.any())
    assert bool((res2[res < 0] == -1).all())
    assert int(res.max()) < scene.count and int(res2.max()) < scene.count
    half = cfg.replace(samples_per_pixel=2)
    img_a, res_a = k4.render_sweep_record(scene, cam, half, 2)
    img_b, res_b, res2_b = k4.render_sweep_record(
        scene, cam, half, 2, sample_base=2, record_second=True)
    torch.testing.assert_close(res[:2], res_a, rtol=0, atol=0)
    torch.testing.assert_close(res[2:], res_b, rtol=0, atol=0)
    torch.testing.assert_close(res2[2:], res2_b, rtol=0, atol=0)
    np.testing.assert_allclose(((img_a + img_b) / 2).numpy(), img.numpy(),
                               atol=1e-6)


def test_no_t_max_and_no_sphere_cap():
    """K4, like K1, tests t > t_min only (K2 also tests t < t_max), and
    takes more than the reference's 1,024 sphere slots."""
    n = 1030
    centers = np.zeros((n, 3), np.float32)
    centers[:, 2] = -1000.0  # out of view, except the last sphere
    centers[-1] = (0.0, 0.0, -1.0)
    from bevy_raytrace_tpu_torch.core.types import make_scene

    scene = make_scene(centers, np.full(n, 0.5, np.float32),
                       np.zeros(n, np.int32), [[0.5, 0.5, 0.5]], [0], [0.0],
                       [1.0])
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1, max_depth=1,
                       t_max=0.25)  # nearer than any sphere
    cam = tsc.baseline_config1_camera(2.0)
    _, res = k4.render_sweep_record(scene, cam, cfg)
    assert int(res.max()) == n - 1  # K4 ignores t_max
    _, res_k2, _ = k2.render_record(scene, cam, cfg)
    assert int(res_k2.max()) == -1  # K2 honours it


def _jax_grads(jscene, jcam, kw, w):
    fast = j_fast(JConfig(**kw), interpret=True, forward="sweep")

    def loss(centers, radii, albedo):
        mats = dataclasses.replace(jscene.materials, albedo=albedo)
        sc = dataclasses.replace(jscene, centers=centers, radii=radii,
                                 materials=mats)
        return jnp.sum(fast(sc, jcam, 0) * jnp.asarray(w))

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jscene.centers, jscene.radii, jscene.materials.albedo)]


def test_sweep_fast_renderer_grads_match_jax():
    kw = {**KW, "edge_softness": 0.01}
    jscene, _ = jsc.baseline_config1_scene()
    jcam = jsc.baseline_config1_camera(kw["width"] / kw["height"])
    w = np.random.default_rng(1).standard_normal(
        (kw["height"], kw["width"], 3)).astype(np.float32)
    want = _jax_grads(jscene, jcam, kw, w)

    scene, cam = scene_from_reference(jscene), camera_from_reference(jcam)
    cfg = RenderConfig(**kw)
    leaves = [scene.centers, scene.radii, scene.materials.albedo]
    params = [p.clone().requires_grad_(True) for p in leaves]
    sc = dataclasses.replace(
        scene, centers=params[0], radii=params[1],
        materials=dataclasses.replace(scene.materials, albedo=params[2]))
    before = k4.sweep_record_frame.launches
    img = make_fast_renderer(cfg, forward="sweep")(sc, cam, 0)
    assert k4.sweep_record_frame.launches == before  # CPU: the twin
    # The fast renderer's value is K4's image.
    k4_img, _, _ = k4.render_sweep_record(scene, cam, cfg, 0,
                                          record_second=True)
    torch.testing.assert_close(img.detach(), k4_img, rtol=0, atol=0)
    torch.sum(img * torch.from_numpy(w)).backward()
    for p, b, name in zip(params, want, ("centers", "radii", "albedo")):
        a = p.grad.numpy()
        assert np.isfinite(a).all() and np.abs(b).max() > 0.0
        np.testing.assert_allclose(a, b, rtol=5e-3,
                                   atol=3e-4 * (np.abs(b).max() + 1e-8),
                                   err_msg=name)


@pytest.mark.parametrize("options,match", [
    (dict(forward="sweep", grad_spp_chunk=1), "chunked"),
    (dict(forward="sweep", clusters=object()), "unpermuted"),
], ids=["sweep_with_chunk", "sweep_with_clusters"])
def test_sweep_combinations_that_raise(options, match):
    with pytest.raises(ValueError, match=match):
        make_fast_renderer(RenderConfig(**KW), **options)
