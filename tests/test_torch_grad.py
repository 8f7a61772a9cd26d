"""Autograd through the port's wavefront `render` (bounce-checkpointed, with
the two-sided `edge_softness` term) against `jax.grad` of the JAX package's
`render`, and `Camera.pack()` keeping the autograd graph.

Inputs are the JAX package's scenes and cameras carried across as arrays;
the cotangent image is a fixed seeded probe.  Gradient bound: the JAX
package's rule for two gradient estimates (tests/test_replay_grad.py
`_compare`, `parity.grad_close`) at rtol 2e-3: both packages run the same
expanded-quadratic wavefront in float32 on one CPU, so the straight-through
gradients agree to float32 summation order on these well-conditioned
scenes (48x32, 2 spp, depth 3).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bevy_raytrace_tpu import RenderConfig as JConfig
from bevy_raytrace_tpu import scenes as jsc
from bevy_raytrace_tpu.wavefront.render import render as jrender
from bevy_raytrace_tpu_torch import RenderConfig
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch.core.camera import Camera
from bevy_raytrace_tpu_torch.interop import (
    camera_from_reference,
    scene_from_reference,
)
from bevy_raytrace_tpu_torch.inverse.optimize import (
    _get_scene_params,
    _set_scene_params,
)
from bevy_raytrace_tpu_torch.parity import grad_close
from bevy_raytrace_tpu_torch.wavefront.render import render

torch.set_num_threads(2)

KW = dict(width=48, height=32, samples_per_pixel=2, max_depth=3)
# pack()'s fields: origin, u, v, w, half_width, half_height, lens, focus.
CAM_SLICES = [slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 12),
              slice(12, 13), slice(13, 14), slice(14, 15), slice(15, 16)]


def _probe(cfg):
    n = cfg["height"] * cfg["width"] * 3
    w = np.sin(np.arange(n, dtype=np.float32) * 0.37) + 0.25
    return w.reshape(cfg["height"], cfg["width"], 3)


def _jax_grads(jscene, jcam, kw, names):
    w = jnp.asarray(_probe(kw))
    cfg = JConfig(**kw)

    def loss(params, cam):
        mats = dataclasses.replace(
            jscene.materials,
            **{n: params[n] for n in ("albedo", "fuzz", "ior") if n in params})
        sc = dataclasses.replace(
            jscene, materials=mats,
            **{n: params[n] for n in ("centers", "radii") if n in params})
        return jnp.sum(jrender(sc, cam, cfg, 1) * w)

    params = {n: {"centers": jscene.centers, "radii": jscene.radii,
                  "albedo": jscene.materials.albedo,
                  "fuzz": jscene.materials.fuzz,
                  "ior": jscene.materials.ior}[n] for n in names}
    gp, gc = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jcam)
    return ({n: np.asarray(v) for n, v in gp.items()}, np.asarray(gc.pack()))


def _torch_grads(scene, cam, kw, names):
    params = {n: p.clone().requires_grad_(True)
              for n, p in _get_scene_params(scene, names).items()}
    cam16 = cam.pack().clone().requires_grad_(True)
    img = render(_set_scene_params(scene, params), Camera.from_packed(cam16),
                 RenderConfig(**kw), 1)
    torch.sum(img * torch.from_numpy(_probe(kw))).backward()
    return ({n: p.grad.numpy() for n, p in params.items()},
            cam16.grad.numpy())


def _assert_grads_close(got, want, got_cam, want_cam, rtol=2e-3):
    glob = max(float(np.abs(v).max()) for v in want.values())
    for n in want:
        stats = grad_close(got[n], want[n], rtol, glob)
        assert stats["ok"], (n, stats)
    cam_glob = float(np.abs(want_cam).max())
    for sl in CAM_SLICES:
        stats = grad_close(got_cam[sl], want_cam[sl], rtol, cam_glob)
        assert stats["ok"], ("camera", sl, stats)


CASES = {
    "config1": (jsc.baseline_config1_scene, jsc.baseline_config1_camera,
                ("centers", "radii", "albedo"), 0.0),
    "config1-edge": (jsc.baseline_config1_scene, jsc.baseline_config1_camera,
                     ("centers", "radii", "albedo"), 0.01),
    "config2": (jsc.baseline_config2_scene, jsc.baseline_config2_camera,
                ("centers", "albedo", "fuzz", "ior"), 0.0),
    "config2-edge": (jsc.baseline_config2_scene, jsc.baseline_config2_camera,
                     ("centers", "radii"), 0.02),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wavefront_grads_match_jax(case):
    scene_fn, cam_fn, names, edge = CASES[case]
    kw = {**KW, "edge_softness": edge}
    jscene, _ = scene_fn()
    jcam = cam_fn(kw["width"] / kw["height"])
    want, want_cam = _jax_grads(jscene, jcam, kw, names)
    got, got_cam = _torch_grads(scene_from_reference(jscene),
                                camera_from_reference(jcam), kw, names)
    assert np.abs(want["centers"]).max() > 0.0
    _assert_grads_close(got, want, got_cam, want_cam)


def test_edge_softness_and_grad_mode_leave_the_image_unchanged():
    """The straight-through term is exactly 1 in value, and the
    bounce-checkpointed graph computes the no-grad image bit for bit."""
    cfg = RenderConfig(**KW)
    scene, _ = tsc.baseline_config2_scene()
    cam = tsc.baseline_config2_camera(cfg.aspect)
    with torch.no_grad():
        plain = render(scene, cam, cfg, 3)
    centers = scene.centers.clone().requires_grad_(True)
    soft = render(dataclasses.replace(scene, centers=centers), cam,
                  cfg.replace(edge_softness=0.05), 3)
    assert soft.requires_grad
    np.testing.assert_array_equal(soft.detach().numpy(), plain.numpy())


def test_camera_pack_keeps_the_graph():
    """A [16] cotangent on pack() reaches every camera field, equal to
    unpack_cotangent of it."""
    base = tsc.rtiow_final_camera(1.5)
    fields = {f.name: getattr(base, f.name).clone().requires_grad_(True)
              for f in dataclasses.fields(base)}
    cam = Camera(**fields)
    d16 = torch.from_numpy(
        np.random.default_rng(5).standard_normal(16).astype(np.float32))
    torch.sum(cam.pack() * d16).backward()
    want = cam.unpack_cotangent(d16)
    for name, leaf in fields.items():
        torch.testing.assert_close(leaf.grad, getattr(want, name),
                                   rtol=0, atol=0)
