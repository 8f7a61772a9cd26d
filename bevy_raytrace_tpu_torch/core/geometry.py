"""Ray-sphere intersection (the `intersect` stage) for the wavefront.

Mirror of `bevy_raytrace_tpu/core/geometry.py`.  The [rays, spheres] test
keeps the reference's expanded quadratic, whose two inner products are
[R,3] x [3,N] matmuls,

    half_b[r,n] = (o_r . d_r) - (d @ C^T)[r,n]
    c_q   [r,n] = |o_r|^2 - 2 (o @ C^T)[r,n] + (|c_n|^2 - rad_n^2)

so this wavefront computes what the JAX wavefront computes.  (The CUDA
kernel uses the better-conditioned centered form, as the TPU kernel does.)
The nearest hit is a masked min + argmin over the sphere axis; torch's
argmin returns the first minimal index, the reference's strict-< rule.

Not ported: the reference's `gather_rows` custom VJP, its bf16 limb split
and the `BRT_ONEHOT_CHUNK_MB` knob.  They exist to make a TPU gather's
transpose run on the matrix unit; plain indexing is the GPU form.
"""

from __future__ import annotations

import torch

from bevy_raytrace_tpu_torch.core.types import Hit, Ray, Scene


def sphere_table(centers, radii, materials, material_id):
    """Per-sphere hit and shade attributes as ONE [S, 11] float32 table:
    [cx, cy, cz, r, albedo_rgb, kind, fuzz, ior, material_id]."""
    mid = material_id.long()
    return torch.cat([
        centers,
        radii[:, None],
        materials.albedo[mid],
        materials.kind[mid].to(torch.float32)[:, None],
        materials.fuzz[mid][:, None],
        materials.ior[mid][:, None],
        material_id.to(torch.float32)[:, None],
    ], dim=1)


def intersect_scene(ray: Ray, scene: Scene, t_min: float, t_max: float) -> Hit:
    """Nearest-hit query for a ray batch against every sphere."""
    table = sphere_table(scene.centers, scene.radii, scene.materials,
                         scene.material_id)
    return intersect_scene_fused(ray, scene, t_min, t_max, table)[0]


def intersect_scene_fused(ray: Ray, scene: Scene, t_min: float, t_max: float,
                          table, with_second: bool = False):
    """`intersect_scene` + material gather in one winner-row gather.

    Returns (Hit, albedo [R,3], kind [R], fuzz [R], ior [R]).
    `with_second=True` appends (hit2 [R] bool, albedo2 [R,3], idx2 [R]): the
    nearest hit excluding the winner sphere (idx2 = -1 on miss).
    """
    o = ray.origin
    d = ray.dir
    c = scene.centers
    rad = scene.radii

    d_dot_c = torch.matmul(d, c.T)
    o_dot_c = torch.matmul(o, c.T)
    o_dot_d = torch.sum(o * d, dim=-1, keepdim=True)
    o2 = torch.sum(o * o, dim=-1, keepdim=True)
    a = torch.sum(d * d, dim=-1, keepdim=True)
    c2_minus_r2 = torch.sum(c * c, dim=-1) - rad * rad

    half_b = o_dot_d - d_dot_c
    c_q = o2 - 2.0 * o_dot_c + c2_minus_r2[None, :]

    disc = half_b * half_b - a * c_q
    hit_any = disc > 0.0
    sqrt_d = torch.sqrt(torch.where(hit_any, disc, 1.0))

    inv_a = 1.0 / a
    root_near = (-half_b - sqrt_d) * inv_a
    root_far = (-half_b + sqrt_d) * inv_a
    near_ok = hit_any & (root_near > t_min) & (root_near < t_max)
    far_ok = hit_any & (root_far > t_min) & (root_far < t_max)
    t_all = torch.where(near_ok, root_near,
                        torch.where(far_ok, root_far, t_max))

    t, idx = torch.min(t_all, dim=-1)
    hit = t < t_max

    g = table[idx]
    center_hit = g[:, 0:3]
    radius_hit = g[:, 3]
    albedo = g[:, 4:7]
    kind = g[:, 7].to(torch.int32)
    fuzz = g[:, 8]
    ior = g[:, 9]
    material = g[:, 10].to(torch.int32)

    # Miss lanes report the ray origin and a fixed unit normal, so that no
    # value downstream overflows (t_max ~ 1e20 would).
    t_safe = torch.where(hit, t, 0.0)
    point = o + t_safe[:, None] * d
    inv_r = 1.0 / torch.where(radius_hit == 0.0, 1.0, radius_hit)
    outward = (point - center_hit) * inv_r[:, None]
    outward = torch.where(hit[:, None], outward, o.new_tensor([0.0, 0.0, 1.0]))
    front_face = torch.sum(d * outward, dim=-1) < 0.0
    normal = torch.where(front_face[:, None], outward, -outward)

    oc_hit = o - center_hit
    oc2_hit = torch.sum(oc_hit * oc_hit, dim=-1)
    ocd_hit = torch.sum(oc_hit * d, dim=-1)
    b_perp2 = oc2_hit - (ocd_hit * ocd_hit) * inv_a[:, 0]
    r2 = torch.clamp(radius_hit * radius_hit, min=1e-12)
    edge_m2 = torch.where(hit, 1.0 - b_perp2 / r2, 1.0)

    out = (Hit(t=t, point=point, normal=normal, front_face=front_face,
               material=material, hit=hit, edge_m2=edge_m2),
           albedo, kind, fuzz, ior)
    if not with_second:
        return out
    cols = torch.arange(t_all.shape[1], device=idx.device)[None, :]
    t2_all = torch.where(cols == idx[:, None], t_max, t_all)
    t2, idx2 = torch.min(t2_all, dim=-1)
    hit2 = t2 < t_max
    albedo2 = table[idx2][:, 4:7]
    return out + ((hit2, albedo2, torch.where(hit2, idx2, -1)),)
