"""The wavefront renderer: the port's differentiable "torch" backend.

Mirror of `bevy_raytrace_tpu/wavefront/render.py`: camera rays for every
(pixel, sample) pair, then `max_depth` rounds of (intersect -> shade) over a
dense, masked wavefront (ray index == pixel index, dead lanes masked, never
compacted), then the mean over samples.  It runs on any device, is the
oracle the CUDA kernels are checked against on the card, and is the default
differentiable renderer of `inverse.render_loss`.

Autograd: each bounce is checkpointed (`torch.utils.checkpoint`) when grad
mode is on, so the backward recomputes a bounce's [rays, spheres] workspace
instead of storing it for every bounce.  With `edge_softness > 0` the
two-sided soft-silhouette straight-through term leaves every pixel value
unchanged and adds the boundary gradient ds * (L_path - L_bg).

Deliberate divergence from the reference: a `ray_chunk` that does not divide
the local pixel count raises.  The reference falls back to the closest
divisor, which can be LARGER than requested and so exceed the workspace
bound the chunk exists to keep.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from bevy_raytrace_tpu_torch.config import RenderConfig
from bevy_raytrace_tpu_torch.core.camera import Camera
from bevy_raytrace_tpu_torch.core.geometry import (
    intersect_scene_fused,
    sphere_table,
)
from bevy_raytrace_tpu_torch.core.materials import scatter, sky_color
from bevy_raytrace_tpu_torch.core.types import Ray, Scene
from bevy_raytrace_tpu_torch.rng.pcg import MASK32, uniform4

# Dedicated RNG stream for camera rays (pixel jitter + lens); bounce events
# use stream == bounce index (0..max_depth-1).
CAMERA_STREAM = 0x9E3779B9
# Frame decorrelation: seed' = seed + FRAME_MIX * frame (mod 2^32).
FRAME_MIX = 0x85EBCA6B


def frame_seed(config: RenderConfig, frame: int) -> int:
    """The 32-bit seed counter of `frame`."""
    return (config.seed + FRAME_MIX * int(frame)) & MASK32


def _bounce_step(scene: Scene, config: RenderConfig, pixel_ids, sample_ids,
                 seed):
    """Returns the body of one (intersect -> shade) round."""
    table = sphere_table(scene.centers, scene.radii, scene.materials,
                         scene.material_id)
    with_second = config.edge_softness > 0.0

    def body(carry, bounce_idx):
        ray, throughput, radiance, alive = carry
        out = intersect_scene_fused(ray, scene, config.t_min, config.t_max,
                                    table, with_second=with_second)
        hit, albedo, kind, fuzz, ior = out[:5]
        u = uniform4(pixel_ids, sample_ids, bounce_idx, seed)
        new_dir, attenuation, scatter_ok = scatter(
            ray.dir, hit.normal, hit.front_face, albedo, kind, fuzz, ior, u)

        sky = sky_color(ray.dir)
        add_sky = (alive & ~hit.hit)[:, None]
        radiance = radiance + torch.where(add_sky, throughput * sky, 0.0)
        scattered = alive & hit.hit
        attenuation_eff = attenuation
        if with_second:
            # Straight-through soft silhouette: st == 1.0 exactly in value
            # (s - s.detach() is exactly 0), so the image is the hard
            # render's; gradients gain ds * (L_path - L_bg), L_bg the
            # runner-up's one-bounce shade (albedo2 * sky) where the edge
            # occludes geometry, else the sky.
            hit2, albedo2, _ = out[5]
            s_soft = torch.sigmoid(hit.edge_m2 / config.edge_softness)
            st = 1.0 + (s_soft - s_soft.detach())
            attenuation_eff = attenuation * st[:, None]
            sky_bg = torch.where(hit2[:, None], albedo2.detach() * sky, sky)
            radiance = radiance + torch.where(
                scattered[:, None], (1.0 - st)[:, None] * throughput * sky_bg,
                0.0)
        throughput = torch.where(scattered[:, None],
                                 throughput * attenuation_eff, throughput)
        alive_next = scattered & scatter_ok

        keep = alive_next[:, None]
        ray = Ray(origin=torch.where(keep, hit.point, ray.origin),
                  dir=torch.where(keep, new_dir, ray.dir))
        return ray, throughput, radiance, alive_next

    return body


def trace_paths(scene, camera, config, pixel_ids, sample_ids, seed):
    """Trace one path per (pixel_id, sample_id) pair -> radiance [K,3].

    Paths still alive after max_depth bounces contribute black."""
    k = pixel_ids.shape[0]
    dev = pixel_ids.device
    cu1, cu2, cu3, cu4 = uniform4(pixel_ids, sample_ids, CAMERA_STREAM, seed)

    x = (pixel_ids % config.width).to(torch.float32)
    y = (pixel_ids // config.width).to(torch.float32)
    # Image row 0 is the top; jittered sub-pixel sampling.
    s = (x + cu1) / config.width
    t = 1.0 - (y + cu2) / config.height
    ray = camera.generate_rays(s, t, cu3, cu4)

    carry = (ray, torch.ones((k, 3), dtype=torch.float32, device=dev),
             torch.zeros((k, 3), dtype=torch.float32, device=dev),
             torch.ones((k,), dtype=torch.bool, device=dev))
    body = _bounce_step(scene, config, pixel_ids, sample_ids, seed)
    remat = torch.is_grad_enabled()
    for bounce in range(config.max_depth):
        carry = (checkpoint(body, carry, bounce, use_reentrant=False,
                            preserve_rng_state=False)
                 if remat else body(carry, bounce))
    return carry[2]


def render_pixel_range(scene: Scene, camera: Camera, config: RenderConfig,
                       pixel_start: int, num_local: int, frame: int = 0):
    """Render `num_local` consecutive pixels from absolute pixel id
    `pixel_start` -> flat [num_local, 3].  RNG counters key on absolute
    pixel ids, so any split of the frame gives the same pixels."""
    seed = frame_seed(config, frame)
    dev = scene.device
    spp_chunk = max(config.spp_chunk, 1)
    ray_chunk = config.ray_chunk or num_local
    if num_local % ray_chunk != 0:
        raise ValueError(
            f"ray_chunk={ray_chunk} does not divide the local pixel count "
            f"{num_local}")

    pixel_ids = torch.arange(num_local, dtype=torch.int64,
                             device=dev) + int(pixel_start)
    sample_offsets = torch.arange(spp_chunk, dtype=torch.int64,
                                  device=dev).repeat_interleave(ray_chunk)
    fb_sum = torch.zeros((num_local, 3), dtype=torch.float32, device=dev)
    for sample_base in range(0, config.samples_per_pixel, spp_chunk):
        parts = []
        for lo in range(0, num_local, ray_chunk):
            pids = pixel_ids[lo:lo + ray_chunk].repeat(spp_chunk)
            rad = trace_paths(scene, camera, config, pids,
                              sample_base + sample_offsets, seed)
            parts.append(rad.reshape(spp_chunk, ray_chunk, 3).sum(dim=0))
        fb_sum = fb_sum + torch.cat(parts)
    return fb_sum / config.samples_per_pixel


def render(scene: Scene, camera: Camera, config: RenderConfig, frame: int = 0):
    """Render one frame -> linear float32 image [height, width, 3]."""
    fb = render_pixel_range(scene, camera, config, 0, config.num_pixels, frame)
    return fb.reshape(config.height, config.width, 3)


def make_renderer(config: RenderConfig):
    """`render(scene, camera, frame=0)` bound to `config`.  For a session
    (frame counter, warmup, backend choice) use `wavefront.engine.Renderer`."""

    def step(scene, camera, frame=0):
        return render(scene, camera, config, frame)

    return step
