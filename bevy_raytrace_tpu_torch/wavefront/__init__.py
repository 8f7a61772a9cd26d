from bevy_raytrace_tpu_torch.wavefront.render import (
    make_renderer,
    render,
    render_pixel_range,
    trace_paths,
)
from bevy_raytrace_tpu_torch.wavefront.engine import Renderer

__all__ = [
    "render",
    "render_pixel_range",
    "make_renderer",
    "trace_paths",
    "Renderer",
]
