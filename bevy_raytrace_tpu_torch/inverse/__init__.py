from bevy_raytrace_tpu_torch.inverse.loss import image_l2_loss, render_loss
from bevy_raytrace_tpu_torch.inverse.fast_grad import (
    make_fast_renderer,
    replay_image,
)
from bevy_raytrace_tpu_torch.inverse.optimize import (
    InverseProblem,
    optimize,
)

__all__ = [
    "image_l2_loss",
    "render_loss",
    "InverseProblem",
    "optimize",
    "make_fast_renderer",
    "replay_image",
]
