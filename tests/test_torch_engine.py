"""The port's Renderer session: backends, frame counter, replan, warmup."""

import numpy as np
import pytest
import torch

from bevy_raytrace_tpu_torch import RenderConfig
from bevy_raytrace_tpu_torch import set_default_device
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch.utils.metrics import FrameTimer
from bevy_raytrace_tpu_torch.wavefront.engine import Renderer
from bevy_raytrace_tpu_torch.wavefront.render import render

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

CFG = RenderConfig(width=32, height=16, samples_per_pixel=2, max_depth=3)


def _scene():
    scene, _ = tsc.baseline_config2_scene()
    return scene, tsc.baseline_config2_camera(CFG.aspect)


def test_torch_backend_frame_counter_and_replan():
    scene, cam = _scene()
    r = Renderer(CFG, backend="torch")
    assert not r.ready
    f0 = r.render_frame(scene, cam)
    f1 = r.render_frame(scene, cam)
    assert r.frame == 2 and r.ready
    np.testing.assert_array_equal(f0.numpy(), render(scene, cam, CFG, 0).numpy())
    np.testing.assert_array_equal(f1.numpy(), render(scene, cam, CFG, 1).numpy())
    r.replan()  # nothing cached: a no-op that keeps the session usable
    timer = FrameTimer(CFG, scene.count)
    f2 = r.render_frame(scene, cam, timer=timer)
    np.testing.assert_array_equal(f2.numpy(), render(scene, cam, CFG, 2).numpy())
    assert r.frame == 3 and len(timer.history) == 1
    m = timer.best
    assert m.frame_time_s > 0 and m.rays_per_sec == CFG.rays_per_frame / m.frame_time_s
    assert "rays/s" in m.line()


def test_warmup_and_warmup_async():
    scene, cam = _scene()
    r = Renderer(CFG, backend="torch")
    assert r.warmup(scene, cam) > 0 and r.ready and r.frame == 0
    fut = r.warmup_async(scene, cam)
    assert fut.result(timeout=60) > 0


def test_cuda_backend_needs_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA device"):
        Renderer(CFG, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        Renderer(CFG, backend="mxu")
