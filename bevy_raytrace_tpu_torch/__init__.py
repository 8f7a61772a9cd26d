"""bevy_raytrace_tpu_torch — the path tracer of `bevy_raytrace_tpu`, in
PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The module layout and public names mirror the JAX package, which stays the
reference this package is tested against.  Importing it needs only torch
and numpy; CUDA kernels are built with nvcc on their first use.

Public API:
    RenderConfig, Camera, Scene, Materials, Ray, MaterialRegistry, render
    scenes.*  (scene builders), wavefront.Renderer (sessions),
    kernels.render_lanes (the K1 kernel and its host side),
    inverse.*  (render_loss, make_fast_renderer, InverseProblem, optimize:
    inverse rendering through the K2 and K3 kernels)
"""

from bevy_raytrace_tpu_torch.config import RenderConfig
from bevy_raytrace_tpu_torch.core.types import Materials, Ray, Scene
from bevy_raytrace_tpu_torch.core.camera import Camera
from bevy_raytrace_tpu_torch.scenes.registry import MaterialRegistry
from bevy_raytrace_tpu_torch.wavefront.render import render

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Camera",
    "Scene",
    "Materials",
    "Ray",
    "MaterialRegistry",
    "render",
    "__version__",
]
