"""The port's inverse rendering recovers a scene, as the JAX package's
tests/test_inverse.py holds it: the same problems, carried across as
arrays (the target is the JAX package's render, the perturbed scene and
the camera go through `interop`), through the wavefront and through
`make_fast_renderer`'s two recorders (on the CPU, K2's and K4's plain twins
with K3's).  Then `optimize(optimizer=)` against the reference's
`optimizer=` and its checkpoint.

Bounds:
  * recovery: the reference's own bars.  The ball (32x24, 4 spp, depth 3,
    edge_softness 0.01, 80 Adam steps at lr 1e-2): last loss < 0.3x the
    first, center error < 0.4x the initial (L2), albedo error < 0.08 (max
    abs).  The occluder (48x32, 8 spp, edge_softness 0.02, 80 steps):
    last loss < 0.5x the first, center error < 0.5x the initial;
  * the wavefront's last loss after 80 steps within [0.75, 1.33]x of the
    JAX package's own `optimize` (one run of each; a loss is one two-sample
    estimate, so the two runs' last losses differ by their noise);
  * SGD with momentum: losses within rtol 1e-3 of optax.sgd over 3 steps
    (torch.optim and optax differ in the last ulp of each update, as for
    Adam in tests/test_torch_fast_grad.py);
  * a resumed run against an uninterrupted one: bit for bit (CPU).
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from bevy_raytrace_tpu import RenderConfig as JConfig
from bevy_raytrace_tpu import scenes as jsc
from bevy_raytrace_tpu.core.camera import Camera as JCamera
from bevy_raytrace_tpu.inverse import InverseProblem as JProblem
from bevy_raytrace_tpu.inverse import optimize as j_optimize
from bevy_raytrace_tpu.scenes.builders import _build
from bevy_raytrace_tpu.scenes.registry import MaterialRegistry
from bevy_raytrace_tpu.wavefront.render import render as j_render
from bevy_raytrace_tpu_torch import RenderConfig, set_default_device
from bevy_raytrace_tpu_torch.interop import (
    camera_from_reference,
    scene_from_reference,
)
from bevy_raytrace_tpu_torch.inverse import (
    InverseProblem,
    make_fast_renderer,
    optimize,
)

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

BALL = dict(width=32, height=24, samples_per_pixel=4, max_depth=3)
ALBEDO, SHIFT = [0.2, 0.8, 0.6], [0.06, -0.04, 0.05]
STEPS = 80


def _render_fn(path, cfg):
    """None for the wavefront; else make_fast_renderer's recorder."""
    if path == "wavefront":
        return None
    fast = make_fast_renderer(cfg, forward=path)
    return lambda s, c, _, f: fast(s, c, f)


def _ball_problem():
    """tests/test_inverse.py's problem: config1 rendered by the JAX package
    at frame 12345, the ball's albedo set and center moved.  -> (JAX true
    scene, JAX perturbed scene, JAX camera, JAX target)."""
    jtrue, _ = jsc.baseline_config1_scene()
    jcam = jsc.baseline_config1_camera(BALL["width"] / BALL["height"])
    jtarget = jax.jit(j_render, static_argnums=2)(
        jtrue, jcam, JConfig(**BALL), 12345)
    mats = dataclasses.replace(
        jtrue.materials,
        albedo=jtrue.materials.albedo.at[1].set(jnp.asarray(ALBEDO)))
    jbad = dataclasses.replace(
        jtrue, materials=mats, centers=jtrue.centers.at[1].add(
            jnp.asarray(SHIFT)))
    return jtrue, jbad, jcam, jtarget


def _errors(scene, true_centers, true_albedo, row):
    """(center error L2, albedo error max abs) of sphere `row`."""
    c = scene.centers[row].detach().cpu().numpy()
    a = scene.materials.albedo[row].detach().cpu().numpy()
    return (float(np.linalg.norm(c - true_centers[row])),
            float(np.abs(a - true_albedo[row]).max()))


@pytest.fixture(scope="module")
def ball():
    """The ball's problem on both sides, JAX's own 80-step optimize once,
    and the port's 80-step runs by path (filled as the tests ask)."""
    jtrue, jbad, jcam, jtarget = _ball_problem()
    jcfg = JConfig(**BALL, edge_softness=0.01)
    want = j_optimize(jbad, JProblem(config=jcfg, camera=jcam, target=jtarget,
                                     optimizable=("centers", "albedo")),
                      steps=STEPS, learning_rate=1e-2)
    return {"cfg": RenderConfig(**BALL, edge_softness=0.01),
            "cam": camera_from_reference(jcam),
            "target": torch.from_numpy(np.array(jtarget)),
            "bad": scene_from_reference(jbad),
            "true_centers": np.asarray(jtrue.centers),
            "true_albedo": np.asarray(jtrue.materials.albedo),
            "jax": want, "runs": {}}


def _recover(ball, path):
    if path not in ball["runs"]:
        cfg = ball["cfg"]
        problem = InverseProblem(config=cfg, camera=ball["cam"],
                                 target=ball["target"],
                                 optimizable=("centers", "albedo"),
                                 render_fn=_render_fn(path, cfg))
        ball["runs"][path] = optimize(ball["bad"], problem, steps=STEPS,
                                      learning_rate=1e-2)
    return ball["runs"][path]


@pytest.mark.parametrize("path", ["wavefront", "pallas", "sweep"])
def test_optimization_reduces_loss_and_recovers(ball, path):
    """80 Adam steps on the ball's center and albedo through the wavefront,
    K2's twin (forward="pallas") and K4's twin (forward="sweep") each clear
    the reference test's three bars."""
    result = _recover(ball, path)
    assert result.step == STEPS and len(result.losses) == STEPS
    assert all(np.isfinite(result.losses))
    assert result.losses[-1] < 0.3 * result.losses[0], result.losses[::10]
    args = (ball["true_centers"], ball["true_albedo"], 1)
    err0, _ = _errors(ball["bad"], *args)
    err1, albedo_err = _errors(result.scene, *args)
    assert err1 < 0.4 * err0, (err0, err1)
    assert albedo_err < 0.08, albedo_err


def test_wavefront_last_loss_matches_jax_optimize(ball):
    """The wavefront's last loss after 80 steps lies within [0.75, 1.33]x
    of the JAX package's own optimize on the same problem."""
    got = _recover(ball, "wavefront").losses[-1]
    want = ball["jax"].losses[-1]
    assert 0.75 * want <= got <= 1.33 * want, (got, want)


def test_occluded_geometry_recovery():
    """tests/test_inverse.py's occluder: a sphere whose silhouette lies over
    another sphere, not sky.  80 Adam steps on the centers through the fast
    renderer's K2 twin (the wavefront takes ~4x as long at 48x32x8) pull
    the occluder back toward the truth."""
    cfg = JConfig(width=48, height=32, samples_per_pixel=8, max_depth=3)
    jcam = JCamera.look_at(lookfrom=(0.0, 0.0, 1.0), lookat=(0.0, 0.0, -1.0),
                           vfov_deg=40.0, aspect=1.5, aperture=0.0)
    reg = MaterialRegistry()
    g = reg.lambertian("ground", (0.5, 0.5, 0.5))
    mb = reg.lambertian("back", (0.1, 0.2, 0.7))
    ma = reg.lambertian("front", (0.8, 0.3, 0.1))
    jtrue = _build([
        ((0.0, -100.5, -1.0), 100.0, g),
        ((0.0, 0.1, -2.5), 1.1, mb),      # big sphere fills the backdrop
        ((0.15, 0.05, -1.0), 0.25, ma),   # occluder: every edge over B
    ], reg)
    jtarget = jax.jit(j_render, static_argnums=2)(jtrue, jcam, cfg, 7)
    jbad = dataclasses.replace(jtrue, centers=jtrue.centers.at[2].add(
        jnp.asarray([0.08, -0.05, 0.0])))

    opt_cfg = RenderConfig(width=48, height=32, samples_per_pixel=8,
                           max_depth=3, edge_softness=0.02)
    bad = scene_from_reference(jbad)
    problem = InverseProblem(config=opt_cfg,
                             camera=camera_from_reference(jcam),
                             target=torch.from_numpy(np.array(jtarget)),
                             optimizable=("centers",),
                             render_fn=_render_fn("pallas", opt_cfg))
    result = optimize(bad, problem, steps=STEPS, learning_rate=1e-2)
    assert result.losses[-1] < 0.5 * result.losses[0], result.losses[::10]
    true_centers = np.asarray(jtrue.centers)
    err0 = np.linalg.norm(bad.centers[2].numpy() - true_centers[2])
    err1 = np.linalg.norm(result.scene.centers[2].numpy() - true_centers[2])
    assert err1 < 0.5 * err0, (err0, err1)


# --- optimizer= and its checkpoint ------------------------------------------

def _sgd(ps):
    return torch.optim.SGD(ps, lr=1e-2, momentum=0.9)


def test_sgd_momentum_matches_optax_sgd():
    """optimizer=SGD with momentum 0.9 through the wavefront, 3 steps on the
    ball's center and albedo, against the reference's optimizer=
    optax.sgd(1e-2, momentum=0.9) from the same start."""
    _, jbad, jcam, jtarget = _ball_problem()
    jcfg = JConfig(**BALL, edge_softness=0.01)
    want = j_optimize(jbad, JProblem(config=jcfg, camera=jcam, target=jtarget,
                                     optimizable=("centers", "albedo")),
                      steps=3, optimizer=optax.sgd(1e-2, momentum=0.9))
    problem = InverseProblem(config=RenderConfig(**BALL, edge_softness=0.01),
                             camera=camera_from_reference(jcam),
                             target=torch.from_numpy(np.array(jtarget)),
                             optimizable=("centers", "albedo"))
    # learning_rate is not used when a factory is given, as in the reference.
    got = optimize(scene_from_reference(jbad), problem, steps=3,
                   learning_rate=123.0, optimizer=_sgd)
    assert got.step == 3 and len(got.losses) == 3
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-3)


def _fast_ball_problem():
    _, jbad, jcam, jtarget = _ball_problem()
    cfg = RenderConfig(**BALL, edge_softness=0.01)
    problem = InverseProblem(config=cfg, camera=camera_from_reference(jcam),
                             target=torch.from_numpy(np.array(jtarget)),
                             optimizable=("centers", "albedo"),
                             render_fn=_render_fn("pallas", cfg))
    return scene_from_reference(jbad), problem


def test_sgd_resume_is_bit_identical(tmp_path):
    """SGD with momentum: 2 steps + checkpoint + resume for 2 more == 4
    uninterrupted steps, bit for bit, through the fast renderer (K2's and
    K3's twins).  The checkpoint holds SGD's momentum buffer by name."""
    bad, problem = _fast_ball_problem()
    straight = optimize(bad, problem, steps=4, optimizer=_sgd)
    path = os.path.join(tmp_path, "ck.npz")
    first = optimize(bad, problem, steps=2, optimizer=_sgd,
                     checkpoint_path=path, checkpoint_every=2)
    with np.load(path, allow_pickle=False) as z:
        assert sorted(z.files) == sorted([
            "step", "param.centers", "param.albedo",
            "momentum_buffer.centers", "momentum_buffer.albedo"])
    resumed = optimize(bad, problem, steps=4, optimizer=_sgd,
                       checkpoint_path=path, checkpoint_every=100)
    assert resumed.step == 4
    assert first.losses + resumed.losses == straight.losses
    np.testing.assert_array_equal(resumed.scene.centers.numpy(),
                                  straight.scene.centers.numpy())
    np.testing.assert_array_equal(resumed.scene.materials.albedo.numpy(),
                                  straight.scene.materials.albedo.numpy())


def test_checkpoint_of_another_optimizer_raises(tmp_path):
    """An Adam checkpoint resumed under SGD with momentum raises, naming the
    state SGD lacks; a plain SGD checkpoint (momentum 0: its buffer is None,
    so nothing of its state is stored) resumed under Adam names Adam's."""
    bad, problem = _fast_ball_problem()
    adam = os.path.join(tmp_path, "adam.npz")
    optimize(bad, problem, steps=1, checkpoint_path=adam, checkpoint_every=1)
    with pytest.raises(ValueError, match="lacks optimizer state "
                                         "'momentum_buffer'"):
        optimize(bad, problem, steps=2, optimizer=_sgd, checkpoint_path=adam)
    plain = os.path.join(tmp_path, "sgd.npz")
    optimize(bad, problem, steps=1, optimizer=lambda ps: torch.optim.SGD(
        ps, lr=1e-2), checkpoint_path=plain, checkpoint_every=1)
    with np.load(plain, allow_pickle=False) as z:
        assert sorted(z.files) == ["param.albedo", "param.centers", "step"]
    with pytest.raises(ValueError, match="lacks optimizer state 'exp_avg'"):
        optimize(bad, problem, steps=2, checkpoint_path=plain)
