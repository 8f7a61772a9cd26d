"""Sharded fast gradients: record and replay per rank stripe, cotangents
summed in one all-reduce.

Mirror of `bevy_raytrace_tpu/inverse/shard_grad.py`, on
`torch.distributed` (one process per device, `shard/mesh.py`):

  forward   each rank runs the recording kernel (K2, or K4 with
            forward="sweep") in stripe mode on its contiguous pixel stripe;
            the residuals stay on the rank between forward and backward,
            and no collective runs;
  backward  each rank runs K3 in stripe mode on its own residuals with its
            stripe of the image cotangent, then EXACTLY ONE all-reduce sums
            one flat float32 buffer holding the [S, 11] table cotangent and
            the 16 camera scalars: (11 S + 16) * 4 bytes, 21,448 B at 486
            spheres.  The renderer counts it in its `stats`.

RNG counters key on ABSOLUTE pixel ids (the kernels' `pixel_base`), so the
sharded image and its gradients match the single-device fast path for any
mesh shape: the image bit for bit, the cotangents to float32 summation
order.
"""

from __future__ import annotations

from bevy_raytrace_tpu_torch.config import RenderConfig
from bevy_raytrace_tpu_torch.inverse.fast_grad import (
    _check_options,
    _FastRender,
    _scene_table,
    _Spec,
)
from bevy_raytrace_tpu_torch.shard.mesh import Mesh
from bevy_raytrace_tpu_torch.shard.render_sharded import (
    all_reduce_flat,
    gather_stripes,
    local_pixels,
)


def make_fast_renderer_sharded(config: RenderConfig, mesh: Mesh,
                               backward: str = "kernel",
                               forward: str = "pallas", clusters=None):
    """A differentiable sharded `render(scene, camera, frame=0,
    gather=False)` whose forward is the recording kernel on this rank's
    stripe and whose backward is K3 on the stripe plus one all-reduce.

    Returns this rank's flat [local, 3] stripe, or with `gather=True` the
    [H, W, 3] image on every rank (one all-gather; its backward hands each
    rank its stripe of the cotangent).  Scene and camera cotangents come
    back replicated: summed over the ranks.  `forward`, `backward` and
    `clusters` as in `make_fast_renderer`.

    `render.stats` counts the backward's collectives: "all_reduces" and
    "all_reduce_bytes" (the payload of the last one)."""
    _check_options(config, backward, 0, forward, clusters)
    local = local_pixels(config, mesh)
    stats = {"all_reduces": 0, "all_reduce_bytes": 0}

    def reduce(d_tbl, d_cam):
        (d_tbl, d_cam), nbytes = all_reduce_flat([d_tbl, d_cam], mesh)
        stats["all_reduces"] += int(mesh.distributed)
        stats["all_reduce_bytes"] = nbytes
        return d_tbl, d_cam

    spec = _Spec(config, backward, 0, config.edge_softness > 0.0, forward,
                 clusters, pixel_base=mesh.rank * local, num_local=local,
                 reduce=reduce)

    def render_fast(scene, camera, frame: int = 0, gather: bool = False):
        stripe = _FastRender.apply(_scene_table(scene).contiguous(),
                                   camera.pack().contiguous(), spec,
                                   int(frame))
        return gather_stripes(stripe, config, mesh) if gather else stripe

    render_fast.stats = stats
    return render_fast
