from bevy_raytrace_tpu_torch.inverse.loss import image_l2_loss, render_loss
from bevy_raytrace_tpu_torch.inverse.fast_grad import (
    make_fast_renderer,
    replay_image,
)
from bevy_raytrace_tpu_torch.inverse.optimize import (
    InverseProblem,
    optimize,
    optimize_step,
)
from bevy_raytrace_tpu_torch.inverse.shard_grad import (
    make_fast_renderer_sharded,
)

__all__ = [
    "image_l2_loss",
    "render_loss",
    "InverseProblem",
    "optimize",
    "optimize_step",
    "make_fast_renderer",
    "make_fast_renderer_sharded",
    "replay_image",
]
