"""The port's wavefront `render` against the JAX package's, on the same
scene, camera, config, seed and frame (64x32).

Image bound: the tight interpret-mode bound of tests/test_mxu.py
(parity.INTERPRET: median <= 1e-6, <= 0.05% of pixels > 1e-4).  It holds
because both packages run the same expanded-quadratic wavefront in float32
on one CPU; only the last ulp of sin/cos/exp/log and the order of three-term
sums differ, which moves no discrete path choice on these scenes."""

import numpy as np
import jax
import pytest
import torch

from bevy_raytrace_tpu import RenderConfig as JConfig
from bevy_raytrace_tpu import scenes as jsc
from bevy_raytrace_tpu.wavefront.render import render as jrender
from bevy_raytrace_tpu_torch import RenderConfig
from bevy_raytrace_tpu_torch import set_default_device
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch.interop import (
    camera_from_reference,
    scene_from_reference,
)
from bevy_raytrace_tpu_torch.parity import INTERPRET, compare
from bevy_raytrace_tpu_torch.wavefront.render import (
    make_renderer,
    render,
    render_pixel_range,
)

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

SCENES = {
    "config1": (lambda: jsc.baseline_config1_scene(),
                jsc.baseline_config1_camera),
    "config2": (lambda: jsc.baseline_config2_scene(),
                jsc.baseline_config2_camera),
    "rtiow_final": (lambda: jsc.rtiow_final_scene(seed=3, grid=2),
                    jsc.rtiow_final_camera),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_matches_reference(name):
    kw = dict(width=64, height=32, samples_per_pixel=2, max_depth=4)
    build, camera = SCENES[name]
    jscene, _ = build()
    jcam = camera(64 / 32)
    want = np.asarray(jax.jit(jrender, static_argnums=2)(
        jscene, jcam, JConfig(**kw), 1))
    got = render(scene_from_reference(jscene), camera_from_reference(jcam),
                 RenderConfig(**kw), 1)
    assert got.shape == (32, 64, 3) and got.dtype == torch.float32
    stats = compare(got.numpy(), want, INTERPRET)
    assert stats["ok"], stats


def test_chunking_and_pixel_ranges():
    """ray_chunk and stripes are exact (per-pixel work is unchanged);
    spp_chunk only regroups the per-pixel sum, allclose at float32."""
    cfg = RenderConfig(width=32, height=16, samples_per_pixel=4, max_depth=3)
    scene, _ = tsc.baseline_config2_scene()
    cam = tsc.baseline_config2_camera(cfg.aspect)
    full = render(scene, cam, cfg)
    chunked = render(scene, cam, cfg.replace(ray_chunk=128))
    np.testing.assert_array_equal(chunked.numpy(), full.numpy())
    stripe = render_pixel_range(scene, cam, cfg, 128, 256)
    np.testing.assert_array_equal(stripe.numpy(),
                                  full.reshape(-1, 3)[128:384].numpy())
    grouped = make_renderer(cfg.replace(spp_chunk=2))(scene, cam)
    np.testing.assert_allclose(grouped.numpy(), full.numpy(), atol=1e-6)


def test_nondividing_ray_chunk_raises():
    """Deliberate divergence: the reference would pick a closest divisor,
    possibly larger than requested; the port refuses."""
    cfg = RenderConfig(width=10, height=10, samples_per_pixel=1, max_depth=2,
                       ray_chunk=20)
    scene, _ = tsc.baseline_config1_scene()
    cam = tsc.baseline_config1_camera(cfg.aspect)
    with pytest.raises(ValueError, match="does not divide"):
        render_pixel_range(scene, cam, cfg, 0, 30)


def test_depth_zero_black_and_frames_decorrelate():
    cfg = RenderConfig(width=32, height=16, samples_per_pixel=1, max_depth=0)
    scene, _ = tsc.baseline_config1_scene()
    cam = tsc.baseline_config1_camera(cfg.aspect)
    assert float(render(scene, cam, cfg).abs().max()) == 0.0
    cfg = cfg.replace(max_depth=3)
    a, b = render(scene, cam, cfg, 0), render(scene, cam, cfg, 1)
    assert float((a - b).abs().max()) > 1e-3
    np.testing.assert_array_equal(a.numpy(), render(scene, cam, cfg, 0).numpy())
