from bevy_raytrace_tpu_torch.scenes.registry import MaterialRegistry
from bevy_raytrace_tpu_torch.scenes.builders import (
    baseline_config1_scene,
    baseline_config1_camera,
    baseline_config2_scene,
    baseline_config2_camera,
    rtiow_final_scene,
    rtiow_final_camera,
    reference_scene,
    random_scene,
    sphereflake_scene,
    sphereflake_camera,
)

__all__ = [
    "MaterialRegistry",
    "baseline_config1_scene",
    "baseline_config1_camera",
    "baseline_config2_scene",
    "baseline_config2_camera",
    "rtiow_final_scene",
    "rtiow_final_camera",
    "reference_scene",
    "random_scene",
    "sphereflake_scene",
    "sphereflake_camera",
]
