"""Material scatter models and sky (the `shade` stage).

Mirror of `bevy_raytrace_tpu/core/materials.py`: Lambertian with the RTiOW
near-zero guard, metal with fuzz and the below-horizon absorb check,
dielectric with total internal reflection and Schlick, and the sky
gradient.  `scatter` computes all three models for every ray and selects by
material kind, as the reference does, so the wavefront stays branch-free.
"""

from __future__ import annotations

import torch

from bevy_raytrace_tpu_torch.core.types import DIELECTRIC, LAMBERTIAN, METALLIC
from bevy_raytrace_tpu_torch.rng.pcg import (
    random_in_unit_sphere,
    random_unit_vector,
)

_NEAR_ZERO = 1.0e-8


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def rsqrt_guard(n2, eps=1.0e-20):
    return 1.0 / torch.sqrt(torch.clamp(n2, min=eps))


def _normalize_guarded(v):
    return v * rsqrt_guard(torch.sum(v * v, dim=-1, keepdim=True))


def sky_color(unit_dir):
    """Background gradient: lerp(white, (0.5, 0.7, 1.0), 0.5*(dir.y + 1))."""
    t = 0.5 * (unit_dir[..., 1] + 1.0)
    white = unit_dir.new_tensor([1.0, 1.0, 1.0])
    blue = unit_dir.new_tensor([0.5, 0.7, 1.0])
    return (1.0 - t)[..., None] * white + t[..., None] * blue


def reflect(v, n):
    """Mirror reflection."""
    return v - 2.0 * _dot(v, n)[..., None] * n


def refract(unit_v, n, etai_over_etat, cos_theta):
    """Snell refraction (RTiOW form).

    The sqrt is guarded at the total-internal-reflection boundary (k -> 0)
    the way the reference guards it: the value is sqrt(k) either way, and
    below k = 1e-12 the unbounded derivative of sqrt is cut."""
    r_out_perp = etai_over_etat[..., None] * (unit_v + cos_theta[..., None] * n)
    k = torch.abs(1.0 - torch.sum(r_out_perp * r_out_perp, dim=-1))
    k_ok = k > 1e-12
    sqrt_k = torch.where(k_ok, torch.sqrt(torch.where(k_ok, k, 1.0)),
                         torch.sqrt(k).detach())
    return r_out_perp - sqrt_k[..., None] * n


def schlick(cos_theta, refl_ratio):
    """Schlick fresnel approximation.  (1 - cos)^5 is evaluated as
    m * (m^2)^2, the product order of the reference's integer power."""
    r0 = (1.0 - refl_ratio) / (1.0 + refl_ratio)
    r0 = r0 * r0
    m = 1.0 - cos_theta
    m2 = m * m
    return r0 + (1.0 - r0) * (m * (m2 * m2))


def scatter(unit_dir, hit_normal, front_face, albedo, kind, fuzz, ior, u):
    """Branch-free scatter for a ray batch.

    unit_dir/hit_normal [R,3]; front_face [R] bool; albedo [R,3]; kind,
    fuzz, ior [R]; u: four uniforms, each [R].
    Returns (new_dir [R,3], attenuation [R,3], scatter_ok [R]).
    """
    u1, u2, u3, u4 = u

    # Lambertian.
    lam_raw = hit_normal + random_unit_vector(u1, u2)
    lam_degenerate = torch.sum(torch.abs(lam_raw), dim=-1) < _NEAR_ZERO
    lam_dir = _normalize_guarded(
        torch.where(lam_degenerate[:, None], hit_normal, lam_raw))

    # Metallic.
    reflected = reflect(unit_dir, hit_normal)
    met_dir = _normalize_guarded(
        reflected + fuzz[:, None] * random_in_unit_sphere(u1, u2, u3))
    met_ok = _dot(met_dir, hit_normal) > 0.0

    # Dielectric.
    refraction_ratio = torch.where(front_face, 1.0 / ior, ior)
    cos_theta = torch.clamp(_dot(-unit_dir, hit_normal), max=1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    cannot_refract = refraction_ratio * sin_theta > 1.0
    use_reflect = cannot_refract | (schlick(cos_theta, refraction_ratio) > u4)
    refracted = refract(unit_dir, hit_normal, refraction_ratio, cos_theta)
    die_dir = _normalize_guarded(
        torch.where(use_reflect[:, None], reflected, refracted))

    is_lam = (kind == LAMBERTIAN)[:, None]
    is_met = (kind == METALLIC)[:, None]
    is_die = (kind == DIELECTRIC)[:, None]
    new_dir = torch.where(is_lam, lam_dir, torch.where(is_met, met_dir, die_dir))
    attenuation = torch.where(is_die, torch.ones_like(albedo), albedo)
    scatter_ok = torch.where(kind == METALLIC, met_ok, True)
    return new_dir, attenuation, scatter_ok
