"""The ball-recovery problems of inverse rendering: config1 with its ball
(sphere 1) perturbed, to be recovered by gradient descent on the image.

`perturbed_problem` builds every one of them: at its defaults the `cli
inverse` command's (the command calls it with its own arguments),
`cli_inverse_problem` that command's at its default size, and
`ball_inverse_problem` the reference's recovery test's
(tests/test_inverse.py `test_optimization_reduces_loss_and_recovers`).
`ball_errors` and `RECOVERY_BARS` are how that test measures and judges a
recovery.
"""

from __future__ import annotations

import dataclasses

import torch

from bevy_raytrace_tpu_torch import scenes
from bevy_raytrace_tpu_torch.config import RenderConfig
from bevy_raytrace_tpu_torch.device import resolve
from bevy_raytrace_tpu_torch.inverse.fast_grad import make_fast_renderer
from bevy_raytrace_tpu_torch.inverse.optimize import InverseProblem
from bevy_raytrace_tpu_torch.wavefront.render import render

# The reference recovery test's bars (tests/test_inverse.py): the last loss
# below LOSS x the first, the center error below CENTER x the initial, the
# albedo error below ALBEDO.
RECOVERY_BARS = {"loss": 0.3, "center": 0.4, "albedo": 0.08}


def perturbed_problem(config: RenderConfig, device=None, renderer=None,
                      camera=None, frame: int = 9999,
                      shift=(0.25, -0.1, 0.1)):
    """config1 rendered by the wavefront at `config` and `frame` (the
    target); the ball's albedo set to (0.2, 0.8, 0.6) and its center moved
    by `shift`; the center and albedo optimizable at edge_softness 0.01.
    `camera` defaults to config1's.  `renderer(optimization config)` gives
    the problem's render_fn; without one (or when it gives None) the loss
    differentiates the wavefront `render`.  Returns (perturbed scene, true
    scene, InverseProblem)."""
    device = resolve(device)
    scene_true = scenes.baseline_config1_scene(device=device)[0]
    if camera is None:
        camera = scenes.baseline_config1_camera(config.aspect, device=device)
    with torch.no_grad():
        target = render(scene_true, camera, config, frame)
    albedo = scene_true.materials.albedo.clone()
    albedo[1] = torch.tensor([0.2, 0.8, 0.6], device=device)
    centers = scene_true.centers.clone()
    centers[1] += torch.tensor(shift, device=device)
    scene_bad = dataclasses.replace(
        scene_true, centers=centers,
        materials=dataclasses.replace(scene_true.materials, albedo=albedo))
    opt_config = dataclasses.replace(config, edge_softness=0.01)
    problem = InverseProblem(
        config=opt_config, camera=camera, target=target,
        optimizable=("centers", "albedo"),
        render_fn=renderer(opt_config) if renderer is not None else None)
    return scene_bad, scene_true, problem


def _fast(forward: str):
    """A `renderer` for `perturbed_problem`: make_fast_renderer(forward=...)
    for forward "pallas" (K2) or "sweep" (K4), K3 backward; "wavefront"
    gives None (the loss differentiates the wavefront `render`)."""
    if forward == "wavefront":
        return None

    def renderer(opt_config):
        fast = make_fast_renderer(opt_config, forward=forward)
        return lambda sc, c, cf, fr: fast(sc, c, fr)

    return renderer


def cli_inverse_problem(device, forward: str = "pallas"):
    """The `cli inverse` problem at its defaults: 1200x800, 64 spp, depth 8,
    through make_fast_renderer(forward=...), or the wavefront for
    forward="wavefront".  Returns what `perturbed_problem` returns."""
    cfg = RenderConfig(width=1200, height=800, samples_per_pixel=64,
                       max_depth=8)
    return perturbed_problem(cfg, device, _fast(forward))


def ball_inverse_problem(device, forward: str = "pallas"):
    """The reference's recovery test: 32x24, 4 spp, depth 3, the target
    rendered at frame 12345, the ball's center moved by (0.06, -0.04, 0.05).
    `forward` as in `cli_inverse_problem`.  The wavefront traces the 4
    samples in one pass (spp_chunk 4: the same samples, a quarter of the
    launches of one pass a sample; the fast renderer does not read it)."""
    cfg = RenderConfig(width=32, height=24, samples_per_pixel=4, max_depth=3,
                       spp_chunk=4)
    return perturbed_problem(cfg, device, _fast(forward),
                             frame=12345, shift=(0.06, -0.04, 0.05))


def ball_errors(scene, scene_true):
    """(center error, albedo error) of the ball (sphere 1): the L2 distance
    of its center and the largest channel error of its albedo, as the
    reference's recovery test measures them."""
    c = float((scene.centers[1] - scene_true.centers[1]).norm())
    a = float((scene.materials.albedo[1]
               - scene_true.materials.albedo[1]).abs().max())
    return c, a
