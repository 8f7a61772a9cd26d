"""The port's entry points work on the CUDA device unless the caller asks
for the CPU: `default_device()` returns the card or raises, and never falls
back to the CPU."""

import pytest
import torch

from bevy_raytrace_tpu_torch import RenderConfig
from bevy_raytrace_tpu_torch import default_device, set_default_device
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch import device as tdevice
from bevy_raytrace_tpu_torch.core.camera import Camera
from bevy_raytrace_tpu_torch.shard import make_mesh
from bevy_raytrace_tpu_torch.wavefront.engine import Renderer

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

CFG = RenderConfig(width=16, height=8, samples_per_pixel=1, max_depth=2)


@pytest.fixture
def no_override():
    """The package's own rule, with no device asked for."""
    set_default_device(None)
    yield
    set_default_device("cpu")


def test_without_a_card_nothing_defaults_to_the_cpu(no_override, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="found none"):
        default_device()
    for entry in (lambda: Renderer(CFG), lambda: Renderer(CFG, "torch"),
                  tsc.baseline_config1_scene,
                  lambda: tsc.rtiow_final_camera(2.0),
                  lambda: Camera.from_packed([0.0] * 16), make_mesh):
        with pytest.raises(RuntimeError, match="found none"):
            entry()
    # Asking for the CPU is always honoured.
    scene, _ = tsc.baseline_config1_scene(device="cpu")
    cam = tsc.baseline_config1_camera(CFG.aspect, device="cpu")
    img = Renderer(CFG, backend="torch", device="cpu").render_frame(scene, cam)
    assert img.device.type == "cpu" and img.shape == (8, 16, 3)


def test_with_a_card_the_default_is_the_card(no_override, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert default_device() == torch.device("cuda", 0)
    assert tdevice.resolve(None) == torch.device("cuda", 0)
    assert tdevice.resolve("cpu") == torch.device("cpu")


def test_override_and_tensor_devices():
    assert default_device() == torch.device("cpu")  # this module asked
    assert Renderer(CFG, backend="torch").device == torch.device("cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        Renderer(CFG)  # the default backend is the CUDA kernel
    # A packed tensor keeps its device; an array goes to the default.
    packed = torch.zeros(16, device="meta")
    assert Camera.from_packed(packed).origin.device.type == "meta"
