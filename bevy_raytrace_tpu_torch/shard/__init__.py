from bevy_raytrace_tpu_torch.shard.mesh import (
    RAY_AXES,
    Mesh,
    initialize_multihost,
    make_mesh,
)
from bevy_raytrace_tpu_torch.shard.render_sharded import (
    gather_stripes,
    make_sharded_renderer,
    render_mxu_sharded,
    render_sharded,
)

__all__ = [
    "RAY_AXES",
    "Mesh",
    "make_mesh",
    "initialize_multihost",
    "render_sharded",
    "render_mxu_sharded",
    "make_sharded_renderer",
    "gather_stripes",
]
