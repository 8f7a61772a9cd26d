"""Multi-device rendering on `torch.distributed`: every rank renders one
contiguous stripe of pixels.

Mirror of `bevy_raytrace_tpu/shard/render_sharded.py`.  The rank of
`shard/mesh.py`'s `Mesh` renders the pixels [rank * local, (rank + 1) *
local) with ABSOLUTE pixel ids feeding the RNG counters, so every pixel gets
the samples of the single-device render and the stripes compose bit for bit.

Where JAX returns one row-sharded global array, a rank here returns its own
flat [local, 3] stripe; `gather=True` all-gathers the stripes into the
[H, W, 3] image on every rank.  The forward does no collective unless
`gather` is asked for.

Differentiation: the scene's float leaves and `camera.pack()` enter through
`_Replicated`, the identity whose backward all-reduces the cotangents over
the mesh: the transpose of "replicated", which `shard_map` inserts for the
JAX package.  Every rank then holds the gradient of the SUM of the ranks'
losses.  `gather_stripes`'s backward hands a rank its own stripe of the
image cotangent, so a loss that every rank computes on the gathered image
differentiates to the same gradient.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from bevy_raytrace_tpu_torch.config import RenderConfig
from bevy_raytrace_tpu_torch.core.camera import Camera
from bevy_raytrace_tpu_torch.shard.mesh import RAY_AXES, Mesh
from bevy_raytrace_tpu_torch.wavefront.render import render_pixel_range

__all__ = ["RAY_AXES", "render_sharded", "render_mxu_sharded",
           "make_sharded_renderer", "gather_stripes", "all_reduce_flat"]


def local_pixels(config: RenderConfig, mesh: Mesh) -> int:
    """Pixels per rank; raises when the frame does not divide over them."""
    if config.num_pixels % mesh.world_size != 0:
        raise ValueError(f"num_pixels={config.num_pixels} must divide over "
                         f"{mesh.world_size} devices")
    return config.num_pixels // mesh.world_size


def all_reduce_flat(tensors, mesh: Mesh):
    """Sum each of `tensors` over the mesh's ranks with ONE all-reduce of
    one flat float32 buffer -> (the summed tensors, the buffer's bytes)."""
    sizes = [t.numel() for t in tensors]
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    if mesh.distributed:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    out = [p.reshape(t.shape) for p, t in zip(flat.split(sizes), tensors)]
    return out, flat.numel() * flat.element_size()


class _Replicated(torch.autograd.Function):
    """Identity on replicated tensors; the backward sums their cotangents
    over the mesh in one all-reduce."""

    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh = mesh
        ctx.like = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(shape, dtype=dtype, device=device)
                 if g is None else g
                 for g, (shape, dtype, device) in zip(grads, ctx.like)]
        summed, _ = all_reduce_flat(grads, ctx.mesh)
        return (None, *summed)


def _replicated(scene, camera, mesh: Mesh):
    """(scene, camera) whose float leaves pass through `_Replicated`."""
    m = scene.materials
    centers, radii, albedo, fuzz, ior, cam16 = _Replicated.apply(
        mesh, scene.centers, scene.radii, m.albedo, m.fuzz, m.ior,
        camera.pack())
    scene = dataclasses.replace(
        scene, centers=centers, radii=radii,
        materials=dataclasses.replace(m, albedo=albedo, fuzz=fuzz, ior=ior))
    return scene, Camera.from_packed(cam16)


class _GatherStripes(torch.autograd.Function):
    """All-gather of the ranks' [local, C] stripes into [world * local, C];
    the backward takes this rank's stripe of the cotangent."""

    @staticmethod
    def forward(ctx, mesh, stripe):
        ctx.mesh, ctx.local = mesh, stripe.shape[0]
        parts = [torch.empty_like(stripe) for _ in range(mesh.world_size)]
        dist.all_gather(parts, stripe.contiguous(), group=mesh.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.rank * ctx.local
        return None, g[lo:lo + ctx.local]


def gather_stripes(stripe, config: RenderConfig, mesh: Mesh):
    """The ranks' flat [local, 3] stripes -> the [H, W, 3] image, on every
    rank (one all-gather; none on a mesh without a process group)."""
    full = _GatherStripes.apply(mesh, stripe) if mesh.distributed else stripe
    return full.reshape(config.height, config.width, 3)


def render_sharded(scene, camera, config: RenderConfig, mesh: Mesh,
                   frame: int = 0, gather: bool = False):
    """Render with pixels sharded over every rank of `mesh`, through the
    wavefront (`render_pixel_range`), differentiably.

    Returns this rank's flat [local, 3] stripe, or with `gather=True` the
    [H, W, 3] image on every rank."""
    local = local_pixels(config, mesh)
    if mesh.distributed:
        scene, camera = _replicated(scene, camera, mesh)
    fb = render_pixel_range(scene, camera, config, mesh.rank * local, local,
                            frame)
    return gather_stripes(fb, config, mesh) if gather else fb


@torch.no_grad()
def render_mxu_sharded(scene, camera, config: RenderConfig, mesh: Mesh,
                       frame: int = 0, balance: bool = False,
                       probe_spp: int = 1, gather: bool = False):
    """K1 on this rank's stripe (`render_mxu_lanes` on the stripe's
    absolute pixel ids): bit-identical to the single-device kernel for any
    mesh shape.

    `balance=True` runs a `probe_spp`-sample probe on the rank and sorts
    the rank's OWN pixels by measured path length before the full render:
    the cost balancing stays local, adds no traffic between ranks, and
    never changes a pixel.  Returns the flat [local, 3] stripe, or with
    `gather=True` the [H, W, 3] image on every rank."""
    from bevy_raytrace_tpu_torch.kernels.render_lanes import (
        LANE_ALIGN,
        lane_pad,
        render_mxu_lanes,
    )

    local = local_pixels(config, mesh)
    dev = scene.device
    if config.max_depth <= 0:
        out = torch.zeros((local, 3), dtype=torch.float32, device=dev)
        return gather_stripes(out, config, mesh) if gather else out
    start = mesh.rank * local
    p_pad = lane_pad(local)
    local_ids = torch.arange(p_pad, dtype=torch.int32, device=dev)

    def run(cfg, pids):
        return render_mxu_lanes(scene, camera, cfg,
                                (start + pids).reshape(-1, LANE_ALIGN), frame)

    order = local_ids
    if balance:
        _, ln = run(config.replace(samples_per_pixel=probe_spp, spp_chunk=0),
                    local_ids)
        # Padding lanes keep their place at the end; their ids are past the
        # stripe and are dropped by the scatter below.
        order = torch.cat([
            torch.argsort(ln[:local], stable=True).to(torch.int32),
            local_ids[local:]])
    fb, _ = run(config, order)
    out = torch.zeros((local, 3), dtype=torch.float32, device=dev)
    out[order[:local].long()] = fb[:local]
    return gather_stripes(out, config, mesh) if gather else out


def make_sharded_renderer(config: RenderConfig, mesh: Mesh):
    """`render(scene, camera, frame=0, gather=False)` bound to `config` and
    `mesh`, with replicated inputs: `render_sharded`."""

    def step(scene, camera, frame: int = 0, gather: bool = False):
        return render_sharded(scene, camera, config, mesh, frame, gather)

    return step
