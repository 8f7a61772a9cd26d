"""The wavefront renderer: the port's forward-only "torch" backend.

Mirror of `bevy_raytrace_tpu/wavefront/render.py`: camera rays for every
(pixel, sample) pair, then `max_depth` rounds of (intersect -> shade) over a
dense, masked wavefront (ray index == pixel index, dead lanes masked, never
compacted), then the mean over samples.  It runs on any device and is the
oracle the CUDA kernel is checked against on the card.

Deliberate divergence from the reference: a `ray_chunk` that does not divide
the local pixel count raises.  The reference falls back to the closest
divisor, which can be LARGER than requested and so exceed the workspace
bound the chunk exists to keep.

Autograd (the bounce-checkpointed backward and the `edge_softness`
straight-through term) is not ported yet: the bounce loop runs under
`torch.no_grad()`.
"""

from __future__ import annotations

import torch

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

    def body(carry, bounce_idx):
        ray, throughput, radiance, alive = carry
        hit, albedo, kind, fuzz, ior = intersect_scene_fused(
            ray, scene, config.t_min, config.t_max, table)
        u = uniform4(pixel_ids, sample_ids, bounce_idx, seed)
        new_dir, attenuation, scatter_ok = scatter(
            ray.dir, hit.normal, hit.front_face, albedo, kind, fuzz, ior, u)

        add_sky = (alive & ~hit.hit)[:, None]
        radiance = radiance + torch.where(
            add_sky, throughput * sky_color(ray.dir), 0.0)
        scattered = alive & hit.hit
        throughput = torch.where(scattered[:, None], throughput * attenuation,
                                 throughput)
        alive_next = scattered & scatter_ok

        keep = alive_next[:, None]
        ray = Ray(origin=torch.where(keep, hit.point, ray.origin),
                  dir=torch.where(keep, new_dir, ray.dir))
        return ray, throughput, radiance, alive_next

    return body


@torch.no_grad()
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
    for bounce in range(config.max_depth):
        carry = body(carry, bounce)
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
        for lo in range(0, num_local, ray_chunk):
            pids = pixel_ids[lo:lo + ray_chunk].repeat(spp_chunk)
            rad = trace_paths(scene, camera, config, pids,
                              sample_base + sample_offsets, seed)
            fb_sum[lo:lo + ray_chunk] += rad.reshape(
                spp_chunk, ray_chunk, 3).sum(dim=0)
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
