"""The port's fast gradient path against the JAX package's: the replay
backward (K3's plain twin), `make_fast_renderer`, `render_loss` and
`optimize` with its checkpoint.

The JAX side runs its Pallas kernels as its own tests run them
(`interpret=True`); inputs are its scenes and cameras carried across as
arrays, and cotangents are fixed seeded probes.  Sizes are the JAX tests'
(48x32, 2 spp, depth 3; 32x24 for the optimizer).

Bounds:
  * cotangents: the JAX package's rule for two gradient estimates
    (tests/test_replay_grad.py `_compare`, `parity.grad_close`) at rtol
    2e-3: the replays run the same arithmetic in another order;
  * optimizer losses: rtol 1e-3 over 3 Adam steps (torch.optim.Adam and
    optax.adam differ in the last ulp of each update);
  * a resumed run against an uninterrupted one: bit for bit (CPU).
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bevy_raytrace_tpu import RenderConfig as JConfig
from bevy_raytrace_tpu import scenes as jsc
from bevy_raytrace_tpu.core.geometry import sphere_table as j_sphere_table
from bevy_raytrace_tpu.inverse import InverseProblem as JProblem
from bevy_raytrace_tpu.inverse import make_fast_renderer as j_fast
from bevy_raytrace_tpu.inverse import optimize as j_optimize
from bevy_raytrace_tpu.inverse import render_loss as j_render_loss
from bevy_raytrace_tpu.kernels.pallas_render import render_pallas
from bevy_raytrace_tpu.kernels.replay_grad import replay_grad as j_replay_grad
from bevy_raytrace_tpu.wavefront.render import render as j_render
from bevy_raytrace_tpu_torch import RenderConfig
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch.core.camera import Camera
from bevy_raytrace_tpu_torch.interop import (
    camera_from_reference,
    params_from_reference,
    params_to_arrays,
    residuals_from_reference,
    scene_from_reference,
)
from bevy_raytrace_tpu_torch.inverse import (
    InverseProblem,
    make_fast_renderer,
    optimize,
    render_loss,
    replay_image,
)
from bevy_raytrace_tpu_torch.inverse.fast_grad import _scene_table
from bevy_raytrace_tpu_torch.inverse.optimize import (
    _get_scene_params,
    _set_scene_params,
    load_checkpoint,
    save_checkpoint,
)
from bevy_raytrace_tpu_torch.kernels import record as k2
from bevy_raytrace_tpu_torch.kernels import replay_grad as k3
from bevy_raytrace_tpu_torch.parity import grad_close
from bevy_raytrace_tpu_torch.wavefront.render import render

torch.set_num_threads(2)

KW = dict(width=48, height=32, samples_per_pixel=2, max_depth=3)
CAM_SLICES = [slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 12),
              slice(12, 13), slice(13, 14), slice(14, 15), slice(15, 16)]
SCENES = {"config1": (jsc.baseline_config1_scene, jsc.baseline_config1_camera),
          "config2": (jsc.baseline_config2_scene, jsc.baseline_config2_camera)}


def _probe(height, width, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((height, width, 3)).astype(np.float32)


def _assert_close(got, want, rtol=2e-3):
    """{name: array} pairs under parity.grad_close, one scale per group."""
    glob = max(float(np.abs(v).max()) for v in want.values())
    for n in want:
        stats = grad_close(got[n], want[n], rtol, glob)
        assert stats["ok"], (n, stats)


def _cam_parts(d16):
    return {f"cam{i}": np.asarray(d16)[sl] for i, sl in enumerate(CAM_SLICES)}


# --- K3's twin on the JAX recorder's residuals ----------------------------


@pytest.mark.parametrize("name,edge", [("config1", 0.01), ("config2", 0.0)])
def test_replay_grad_twin_matches_tpu_kernel(name, edge):
    j_scene_fn, j_cam_fn = SCENES[name]
    kw = {**KW, "edge_softness": edge}
    jscene, _ = j_scene_fn()
    jcam = j_cam_fn(kw["width"] / kw["height"])
    jcfg, cfg = JConfig(**kw), RenderConfig(**kw)
    _, jres, *jrest = render_pallas(jscene, jcam, jcfg, 1, interpret=True,
                                    with_residuals=True,
                                    record_second=edge > 0)
    g = _probe(kw["height"], kw["width"])
    jtable = j_sphere_table(jscene.centers, jscene.radii, jscene.materials,
                            jscene.material_id)
    want_tbl, want_cam = j_replay_grad(
        jtable, jcam, jcfg, jres, jnp.asarray(g), 1, interpret=True,
        res2=jrest[0] if jrest else None)
    scene, cam = scene_from_reference(jscene), camera_from_reference(jcam)
    res2 = (residuals_from_reference(jrest[0], cfg.num_pixels)
            if jrest else None)
    got_tbl, got_cam = k3.replay_grad(
        _scene_table(scene), cam.pack(), cfg,
        residuals_from_reference(jres, cfg.num_pixels), torch.from_numpy(g),
        1, res2=res2)
    assert np.abs(np.asarray(want_tbl)).max() > 0.0
    _assert_close({"table": got_tbl.numpy()}, {"table": np.asarray(want_tbl)})
    _assert_close(_cam_parts(got_cam.numpy()), _cam_parts(want_cam))


# --- make_fast_renderer against the JAX fast renderer ---------------------


def _jax_fast_grads(jscene, jcam, kw, names):
    fast = j_fast(JConfig(**kw), interpret=True)
    w = jnp.asarray(_probe(kw["height"], kw["width"], seed=1))

    def loss(params, cam):
        mats = dataclasses.replace(
            jscene.materials,
            **{n: params[n] for n in ("albedo", "fuzz", "ior") if n in params})
        sc = dataclasses.replace(
            jscene, materials=mats,
            **{n: params[n] for n in ("centers", "radii") if n in params})
        return jnp.sum(fast(sc, cam, 0) * w)

    params = {n: {"centers": jscene.centers, "radii": jscene.radii,
                  "albedo": jscene.materials.albedo,
                  "fuzz": jscene.materials.fuzz,
                  "ior": jscene.materials.ior}[n] for n in names}
    gp, gc = jax.grad(loss, argnums=(0, 1))(params, jcam)
    return {n: np.asarray(v) for n, v in gp.items()}, np.asarray(gc.pack())


def _torch_fast_grads(scene, cam, kw, names, **options):
    fast = make_fast_renderer(RenderConfig(**kw), **options)
    params = {n: p.clone().requires_grad_(True)
              for n, p in _get_scene_params(scene, names).items()}
    cam16 = cam.pack().clone().requires_grad_(True)
    img = fast(_set_scene_params(scene, params), Camera.from_packed(cam16), 0)
    w = torch.from_numpy(_probe(kw["height"], kw["width"], seed=1))
    torch.sum(img * w).backward()
    return ({n: p.grad.numpy() for n, p in params.items()},
            cam16.grad.numpy(), img.detach())


@pytest.mark.parametrize("name,edge,names", [
    ("config1", 0.01, ("centers", "radii", "albedo")),
    ("config2", 0.0, ("centers", "albedo", "fuzz", "ior")),
])
def test_fast_renderer_grads_match_jax(name, edge, names):
    j_scene_fn, j_cam_fn = SCENES[name]
    kw = {**KW, "edge_softness": edge}
    jscene, _ = j_scene_fn()
    jcam = j_cam_fn(kw["width"] / kw["height"])
    want, want_cam = _jax_fast_grads(jscene, jcam, kw, names)
    got, got_cam, _ = _torch_fast_grads(scene_from_reference(jscene),
                                        camera_from_reference(jcam), kw,
                                        names)
    assert np.abs(want["centers"]).max() > 0.0
    _assert_close(got, want)
    _assert_close(_cam_parts(got_cam), _cam_parts(want_cam))


def test_fast_forward_is_the_recorder_image_and_backwards_agree():
    """The fast renderer's value is K2's image; on the CPU backward="kernel"
    (K3's twin) and backward="torch" are the same computation; and the
    per-bounce checkpointed replay differentiates exactly like the stored
    one."""
    kw = {**KW, "edge_softness": 0.01}
    cfg = RenderConfig(**kw)
    scene, _ = tsc.baseline_config1_scene()
    cam = tsc.baseline_config1_camera(cfg.aspect)
    names = ("centers", "radii")
    gk, ck, img = _torch_fast_grads(scene, cam, kw, names)
    gt, ct, _ = _torch_fast_grads(scene, cam, kw, names, backward="torch")
    want, res, res2 = k2.render_record(scene, cam, cfg, 0,
                                       record_second=True)
    torch.testing.assert_close(img, want, rtol=0, atol=0)
    for n in names:
        np.testing.assert_array_equal(gk[n], gt[n])
    np.testing.assert_array_equal(ck, ct)

    w = torch.from_numpy(_probe(cfg.height, cfg.width, seed=2))
    grads = []
    for remat in (True, False):
        c = scene.centers.clone().requires_grad_(True)
        rep = replay_image(dataclasses.replace(scene, centers=c), cam, cfg,
                           res, 0, remat=remat, res2=res2)
        torch.sum(rep * w).backward()
        grads.append(c.grad.numpy())
    np.testing.assert_array_equal(grads[0], grads[1])


def test_grad_spp_chunk_matches_unchunked():
    """Recording 2 samples at a time reproduces the unchunked gradient up to
    float32 summation order (the JAX test's bounds)."""
    kw = {**KW, "samples_per_pixel": 4, "edge_softness": 0.01}
    scene, _ = tsc.baseline_config2_scene()
    cam = tsc.baseline_config2_camera(kw["width"] / kw["height"])
    full, cam_full, img_full = _torch_fast_grads(scene, cam, kw, ("centers",))
    chunk, cam_chunk, img_chunk = _torch_fast_grads(
        scene, cam, kw, ("centers",), grad_spp_chunk=2)
    np.testing.assert_allclose(img_chunk.numpy(), img_full.numpy(), rtol=1e-6)
    scale = np.abs(full["centers"]).max()
    np.testing.assert_allclose(chunk["centers"], full["centers"], rtol=1e-4,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(cam_chunk, cam_full, rtol=1e-4,
                               atol=1e-4 * np.abs(cam_full).max())


BAD = {
    "forward=sweep": (dict(forward="sweep"), NotImplementedError, "K4"),
    "clusters": (dict(clusters=object()), NotImplementedError, "clusters"),
    "chunk with torch": (dict(backward="torch", grad_spp_chunk=1), ValueError,
                         "kernel"),
    "chunk not dividing": (dict(grad_spp_chunk=3), ValueError, "divisible"),
    "unknown backward": (dict(backward="xla"), ValueError, "backward"),
    "unknown forward": (dict(forward="mxu"), ValueError, "forward"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_unsupported_options_raise(case):
    options, error, match = BAD[case]
    with pytest.raises(error, match=match):
        make_fast_renderer(RenderConfig(**KW), **options)


def test_replay_grad_rejects_what_it_does_not_take():
    cfg = RenderConfig(**{**KW, "edge_softness": 0.01})
    scene, _ = tsc.baseline_config1_scene()
    cam = tsc.baseline_config1_camera(cfg.aspect)
    _, res, res2 = k2.render_record(scene, cam, cfg, record_second=True)
    table, cam16 = k2._operands(scene, cam)
    g = torch.zeros((cfg.height, cfg.width, 3))
    with pytest.raises(ValueError, match="res2"):
        k3.replay_grad(table, cam16, cfg, res, g)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        k3.replay_grad(table, cam16, cfg, res, g, res2=res2, num_local=64)
    with pytest.raises(TypeError, match="int16 or int32"):
        k3.replay_grad(table, cam16, cfg, res.long(), g, res2=res2)
    with pytest.raises(ValueError, match="shape"):
        k3.replay_grad(table, cam16, cfg, res[:, :2].contiguous(), g,
                       res2=res2[:, :2].contiguous())
    deep = cfg.replace(max_depth=17, edge_softness=0.0)
    _, res_deep, _ = k2.render_record(scene, cam, deep)
    with pytest.raises(ValueError, match="MAX_DEPTH"):
        k3.replay_grad(table, cam16, deep, res_deep, g)


# --- losses, the optimizer and its checkpoint ------------------------------

OPT_CFG = dict(width=32, height=24, samples_per_pixel=4, max_depth=3,
               edge_softness=0.01)


def _perturbed(scene_true, albedo, shift, xp):
    """The inverse tests' perturbation: the ball's albedo and center."""
    if xp is np:  # JAX scene
        mats = dataclasses.replace(
            scene_true.materials,
            albedo=scene_true.materials.albedo.at[1].set(jnp.asarray(albedo)))
        return dataclasses.replace(
            scene_true, materials=mats,
            centers=scene_true.centers.at[1].add(jnp.asarray(shift)))
    a = scene_true.materials.albedo.clone()
    a[1] = torch.tensor(albedo)
    c = scene_true.centers.clone()
    c[1] += torch.tensor(shift)
    return dataclasses.replace(
        scene_true, centers=c,
        materials=dataclasses.replace(scene_true.materials, albedo=a))


ALBEDO, SHIFT = [0.2, 0.8, 0.6], [0.06, -0.04, 0.05]


def test_render_loss_and_optimizer_match_jax():
    """The two-sample loss, then 3 Adam steps on centers and albedo through
    the wavefront, from the same start: losses within rtol 1e-3."""
    jscene_true, _ = jsc.baseline_config1_scene()
    jcam = jsc.baseline_config1_camera(OPT_CFG["width"] / OPT_CFG["height"])
    jcfg = JConfig(**OPT_CFG)
    jtarget = jax.jit(j_render, static_argnums=2)(
        jscene_true, jcam, jcfg.replace(edge_softness=0.0), 12345)
    jbad = _perturbed(jscene_true, ALBEDO, SHIFT, np)
    want = j_optimize(jbad, JProblem(config=jcfg, camera=jcam, target=jtarget,
                                     optimizable=("centers", "albedo")),
                      steps=3, learning_rate=1e-2)

    cfg = RenderConfig(**OPT_CFG)
    cam = camera_from_reference(jcam)
    target = torch.from_numpy(np.array(jtarget))
    bad = scene_from_reference(jbad)
    loss0 = float(render_loss(bad, cam, cfg, target, 0))
    np.testing.assert_allclose(
        loss0, float(j_render_loss(jbad, jcam, jcfg, jnp.asarray(target), 0)),
        rtol=1e-5)
    got = optimize(bad, InverseProblem(config=cfg, camera=cam, target=target,
                                       optimizable=("centers", "albedo")),
                   steps=3, learning_rate=1e-2)
    assert got.step == 3 and len(got.losses) == 3
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-3)
    assert got.losses[0] == loss0


def test_resume_is_bit_identical(tmp_path):
    """2 steps + checkpoint + resume for 2 more == 4 uninterrupted steps, bit
    for bit, through the fast renderer (on the CPU: K2's and K3's twins)."""
    scene_true, _ = tsc.baseline_config1_scene()
    cfg = RenderConfig(**OPT_CFG)
    cam = tsc.baseline_config1_camera(cfg.aspect)
    with torch.no_grad():
        target = render(scene_true, cam, cfg, 7)
    fast = make_fast_renderer(cfg)
    problem = InverseProblem(config=cfg, camera=cam, target=target,
                             optimizable=("centers", "albedo"),
                             render_fn=lambda s, c, _, f: fast(s, c, f))
    bad = _perturbed(scene_true, ALBEDO, SHIFT, torch)
    straight = optimize(bad, problem, steps=4, learning_rate=2e-2)
    path = os.path.join(tmp_path, "ck.npz")
    first = optimize(bad, problem, steps=2, learning_rate=2e-2,
                     checkpoint_path=path, checkpoint_every=2)
    resumed = optimize(bad, problem, steps=4, learning_rate=2e-2,
                       checkpoint_path=path, checkpoint_every=100)
    assert resumed.step == 4
    assert first.losses + resumed.losses == straight.losses
    assert straight.losses[-1] < straight.losses[0]
    for leaf in ("centers",):
        np.testing.assert_array_equal(getattr(resumed.scene, leaf).numpy(),
                                      getattr(straight.scene, leaf).numpy())
    np.testing.assert_array_equal(resumed.scene.materials.albedo.numpy(),
                                  straight.scene.materials.albedo.numpy())


def test_checkpoint_roundtrip_and_interop(tmp_path):
    """An npz of plain arrays (no pickle): step, parameters, Adam state by
    name; parameter dicts cross between the packages as numpy."""
    jparams = {"centers": jnp.arange(6.0).reshape(2, 3),
               "albedo": jnp.full((2, 3), 0.5)}
    params = params_from_reference(jparams)
    state = {n: {"exp_avg": p * 0.1, "exp_avg_sq": p * p,
                 "step": torch.tensor(17.0)} for n, p in params.items()}
    path = os.path.join(tmp_path, "ck.npz")
    save_checkpoint(path, 17, params, state)
    with np.load(path, allow_pickle=False) as z:
        assert "step" in z.files and "param.centers" in z.files
    step, params2, state2 = load_checkpoint(path)
    assert step == 17
    for n in params:
        np.testing.assert_array_equal(params_to_arrays(params2)[n],
                                      np.asarray(jparams[n]))
        for key in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(state2[n][key], state[n][key],
                                       rtol=0, atol=0)
    padded = np.full((2, 3, 10), -1, np.int16)
    assert tuple(residuals_from_reference(padded, 8).shape) == (2, 3, 8)
    with pytest.raises(TypeError, match="int16 or int32"):
        residuals_from_reference(padded.astype(np.float32), 8)
