from bevy_raytrace_tpu_torch.core.types import Hit, Materials, Ray, Scene
from bevy_raytrace_tpu_torch.core.camera import Camera

__all__ = ["Hit", "Materials", "Ray", "Scene", "Camera"]
