from bevy_raytrace_tpu_torch.rng.pcg import (
    pcg4d,
    uniform4,
    random_unit_vector,
    random_in_unit_sphere,
    random_in_unit_disk,
)

__all__ = [
    "pcg4d",
    "uniform4",
    "random_unit_vector",
    "random_in_unit_sphere",
    "random_in_unit_disk",
]
