"""Slow, obviously-correct scalar oracle renderer (pure numpy).

The port's own copy of `bevy_raytrace_tpu/wavefront/oracle.py`: an
*independent* implementation of the same light transport, structured the way
"Ray Tracing in One Weekend" expresses it (a per-path recursive `ray_color`
with a scalar loop over the spheres) rather than as a vectorized wavefront.
It draws from the *same* PCG4D counter streams as the wavefront engine (the
port's `rng.pcg.pcg4d`, bit-exact with the reference's), so `render_oracle`
and `wavefront.render` must agree to float tolerance on any config, and
`render_oracle` must equal the reference's oracle.

It takes the port's `Scene`, `Camera` and `RenderConfig` (tensors on any
device; they are read into float64 numpy arrays once).  Python-loop slow:
use tiny configs (the tests use <= 40x24 x 4 spp).
"""

from __future__ import annotations

import numpy as np

from bevy_raytrace_tpu_torch.config import RenderConfig
from bevy_raytrace_tpu_torch.core.types import DIELECTRIC, LAMBERTIAN, METALLIC
from bevy_raytrace_tpu_torch.rng.pcg import pcg4d
from bevy_raytrace_tpu_torch.wavefront.render import CAMERA_STREAM, frame_seed


def _uniform4(pixel, sample, stream, seed):
    """Four float32 uniforms of the counter (pixel, sample, stream, seed):
    the top 24 bits of each PCG4D word."""
    return tuple(np.float32(int(v) >> 8) * np.float32(1.0 / 16777216.0)
                 for v in pcg4d(int(pixel), int(sample), int(stream),
                                int(seed)))


def _unit_vector(u1, u2):
    z = 1.0 - 2.0 * u1
    r = np.sqrt(max(0.0, 1.0 - z * z))
    phi = 2.0 * np.pi * u2
    return np.array([r * np.cos(phi), r * np.sin(phi), z], np.float64)


def _normalize(v):
    return v / np.linalg.norm(v)


def _hit_sphere(origin, direction, center, radius, t_min, t_max):
    """RTiOW half-b quadratic, near-then-far root."""
    oc = origin - center
    a = float(direction @ direction)
    half_b = float(oc @ direction)
    c = float(oc @ oc) - radius * radius
    disc = half_b * half_b - a * c
    if disc <= 0.0:
        return None
    sq = np.sqrt(disc)
    for root in ((-half_b - sq) / a, (-half_b + sq) / a):
        if t_min < root < t_max:
            return root
    return None


def _ray_color(scene_np, origin, direction, depth, pixel, sample, seed, cfg):
    centers, radii, mat_id, albedo, kind, fuzz, ior = scene_np
    bounce = cfg.max_depth - depth  # bounce index = RNG stream
    if depth == 0:
        return np.zeros(3)  # depth exhausted -> black

    # nearest hit: linear scan, no partitioning
    best_t, best_i = cfg.t_max, -1
    for i in range(len(radii)):
        t = _hit_sphere(origin, direction, centers[i], radii[i], cfg.t_min, best_t)
        if t is not None:
            best_t, best_i = t, i

    unit_d = _normalize(direction)
    if best_i < 0:
        # sky gradient miss
        t = 0.5 * (unit_d[1] + 1.0)
        return (1.0 - t) * np.ones(3) + t * np.array([0.5, 0.7, 1.0])

    point = origin + best_t * direction
    outward = (point - centers[best_i]) / radii[best_i]
    front_face = float(unit_d @ outward) < 0.0
    normal = outward if front_face else -outward

    m = mat_id[best_i]
    u1, u2, u3, u4 = _uniform4(pixel, sample, bounce, seed)

    if kind[m] == LAMBERTIAN:
        scatter_dir = normal + _unit_vector(u1, u2)
        if np.sum(np.abs(scatter_dir)) < 1e-8:
            scatter_dir = normal
        atten = albedo[m]
    elif kind[m] == METALLIC:
        reflected = unit_d - 2.0 * float(unit_d @ normal) * normal
        scatter_dir = reflected + fuzz[m] * _unit_vector(u1, u2) * np.cbrt(u3)
        if float(_normalize(scatter_dir) @ normal) <= 0.0:
            return np.zeros(3)  # absorbed below horizon
        atten = albedo[m]
    elif kind[m] == DIELECTRIC:
        ratio = (1.0 / ior[m]) if front_face else ior[m]
        cos_t = min(float(-unit_d @ normal), 1.0)
        sin_t = np.sqrt(max(0.0, 1.0 - cos_t * cos_t))
        r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
        schlick = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
        if ratio * sin_t > 1.0 or schlick > u4:
            scatter_dir = unit_d - 2.0 * float(unit_d @ normal) * normal
        else:
            r_perp = ratio * (unit_d + cos_t * normal)
            r_par = -np.sqrt(abs(1.0 - float(r_perp @ r_perp))) * normal
            scatter_dir = r_perp + r_par
        atten = np.ones(3)
    else:
        raise ValueError(f"bad material kind {kind[m]}")

    scatter_dir = _normalize(scatter_dir)
    return atten * _ray_color(
        scene_np, point, scatter_dir, depth - 1, pixel, sample, seed, cfg
    )


def render_oracle(scene, camera, cfg: RenderConfig, frame: int = 0):
    """Render with per-path recursion; returns [H, W, 3] float64."""
    def f64(t):
        return t.detach().cpu().numpy().astype(np.float64)

    m = scene.materials
    scene_np = (
        f64(scene.centers),
        f64(scene.radii),
        scene.material_id.cpu().numpy(),
        f64(m.albedo),
        m.kind.cpu().numpy(),
        f64(m.fuzz),
        f64(m.ior),
    )
    cam_origin = f64(camera.origin)
    cam_u = f64(camera.u)
    cam_v = f64(camera.v)
    cam_w = f64(camera.w)
    half_w = float(camera.half_width)
    half_h = float(camera.half_height)
    lens_r = float(camera.lens_radius)
    focus = float(camera.focus_dist)

    seed = frame_seed(cfg, frame)

    img = np.zeros((cfg.height, cfg.width, 3))
    for y in range(cfg.height):
        for x in range(cfg.width):
            pixel = y * cfg.width + x
            acc = np.zeros(3)
            for sp in range(cfg.samples_per_pixel):
                cu1, cu2, cu3, cu4 = _uniform4(pixel, sp, CAMERA_STREAM, seed)
                s = (x + cu1) / cfg.width
                t = 1.0 - (y + cu2) / cfg.height
                target = (
                    cam_origin
                    - focus * cam_w
                    + (2.0 * s - 1.0) * half_w * focus * cam_u
                    + (2.0 * t - 1.0) * half_h * focus * cam_v
                )
                rd = np.sqrt(cu3)
                phi = 2.0 * np.pi * cu4
                offset = lens_r * (
                    rd * np.cos(phi) * cam_u + rd * np.sin(phi) * cam_v
                )
                origin = cam_origin + offset
                direction = _normalize(target - origin)
                acc += _ray_color(
                    scene_np, origin, direction, cfg.max_depth, pixel, sp, seed, cfg
                )
            img[y, x] = acc / cfg.samples_per_pixel
    return img
