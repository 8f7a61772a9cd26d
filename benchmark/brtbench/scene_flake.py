"""The SPD sphereflake's arrays from a configuration's `scene` block.

E. Haines' Standard Procedural Databases (IEEE CG&A 7(11), 1987), `balls.c`:
a sphere with nine children a third of its radius that touch it, each with
nine of its own, down to the block's `flake.level`.  The block's ground (and
its grid and heroes, empty for the flake) are brtbench/scene_gen.py's;
this module appends the flake after them, one material row per sphere.

It is written apart from the port's `scenes.sphereflake_scene`, which a
CPU test holds equal to it: the flake is built level by level on whole
tensors in float64, each sphere's nine directions turned by the least
rotation from +z to its axis in axis-angle form (Rodrigues' rotation of a
vector), then taken into the port's frame by the block's `to_port` matrix
and rounded to float32 once.
"""

from __future__ import annotations

import math

import torch

from brtbench import scene_gen
from brtbench.reference import SceneArrays


def _directions(spec: dict) -> torch.Tensor:
    """The nine child directions about +z, float64 [9, 3]: the equator's,
    then the elevated ones, each list in its order."""
    rows = []
    for a in spec["equator_azimuth_deg"]:
        rows.append((math.cos(math.radians(a)), math.sin(math.radians(a)),
                     0.0))
    el = math.radians(float(spec["elevation_deg"]))
    for a in spec["elevated_azimuth_deg"]:
        rows.append((math.cos(el) * math.cos(math.radians(a)),
                     math.cos(el) * math.sin(math.radians(a)), math.sin(el)))
    return torch.tensor(rows, dtype=torch.float64)


def _turn(axes: torch.Tensor, w: torch.Tensor, antipode_tol: float):
    """Each of `w` [k, 3] turned by the least rotation taking +z to each
    unit axis [n, 3] -> [n, k, 3].  An axis with 1 + z under
    `antipode_tol` (where the least rotation has no unique axis) takes the
    half turn about +y, (x, y, z) -> (-x, y, -z)."""
    cos = axes[:, 2][:, None, None]  # [n, 1, 1]
    k = torch.stack([-axes[:, 1], axes[:, 0], torch.zeros_like(cos[:, 0, 0])],
                    dim=1)  # +z x axis
    sin = torch.linalg.norm(k, dim=1)
    unit = k / torch.where(sin > 0, sin, 1.0)[:, None]
    u = unit[:, None, :].expand(-1, w.shape[0], -1)
    v = w[None].expand(axes.shape[0], -1, -1)
    turned = (v * cos + torch.linalg.cross(u, v) * sin[:, None, None]
              + u * (u * v).sum(-1, keepdim=True) * (1.0 - cos))
    half = v * torch.tensor([-1.0, 1.0, -1.0], dtype=v.dtype)
    flip = (1.0 + cos) < antipode_tol
    return torch.where(flip, half, turned)


def flake_spheres(spec: dict):
    """(centers [N, 3], radii [N]) float64 of the flake of `spec` (the
    block's `flake`), in the port's frame, level by level."""
    dirs = _directions(spec["directions"])
    ratio = float(spec["child_radius_ratio"])
    tol = float(spec["antipode_tolerance"])
    c = torch.tensor([spec["center"]], dtype=torch.float64)
    r = torch.tensor([float(spec["radius"])], dtype=torch.float64)
    a = torch.tensor([spec["axis"]], dtype=torch.float64)
    centers, radii = [c], [r]
    for _ in range(int(spec["level"])):
        w = _turn(a, dirs, tol)  # [n, 9, 3]
        c = (c[:, None, :] + w * (r * (1.0 + ratio))[:, None, None]
             ).reshape(-1, 3)
        r = (r * ratio)[:, None].expand(-1, dirs.shape[0]).reshape(-1)
        a = w.reshape(-1, 3)
        centers.append(c)
        radii.append(r)
    to_port = torch.tensor(spec["to_port"], dtype=torch.float64)
    return torch.cat(centers) @ to_port.T, torch.cat(radii)


def build(block: dict, seed: int, device) -> SceneArrays:
    """The scene of a configuration's `scene` block with a `flake`: the
    block's ground, grid and heroes (scene_gen.build), then the flake."""
    dev = torch.device(device)
    base = scene_gen.build(block, seed, dev)
    spec = block["flake"]
    centers, radii = flake_spheres(spec)
    n = radii.shape[0]
    albedo, kind, fuzz, ior = scene_gen._material_row(spec["material"])
    f32 = torch.float32

    def rows(value, dtype):
        return torch.tensor(value, dtype=dtype, device=dev).expand(
            n, *torch.tensor(value).shape)

    total = base.count + n
    return SceneArrays(
        centers=torch.cat([base.centers, centers.to(dev, f32)]).contiguous(),
        radii=torch.cat([base.radii, radii.to(dev, f32)]).contiguous(),
        material_id=torch.arange(total, dtype=torch.int32, device=dev),
        albedo=torch.cat([base.albedo, rows(albedo, f32)]).contiguous(),
        kind=torch.cat([base.kind, rows(kind, torch.int32)]).contiguous(),
        fuzz=torch.cat([base.fuzz, rows(fuzz, f32)]).contiguous(),
        ior=torch.cat([base.ior, rows(ior, f32)]).contiguous())
