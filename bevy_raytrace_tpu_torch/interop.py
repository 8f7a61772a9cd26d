"""Carry scenes, cameras, cluster plans, inverse-problem parameters and
recorded residuals across from the JAX package as plain arrays.

The two packages share no objects; what one builds reaches the other as
numpy arrays, so tests can feed both exactly the same inputs.  Nothing here
imports JAX: the `*_from_reference` helpers read the JAX objects' fields
through `np.asarray`.
"""

from __future__ import annotations

import numpy as np
import torch

from bevy_raytrace_tpu_torch.core.camera import Camera
from bevy_raytrace_tpu_torch.core.types import Scene, make_scene
from bevy_raytrace_tpu_torch.device import resolve
from bevy_raytrace_tpu_torch.kernels.clusters import ClusterPlan


def scene_from_arrays(centers, radii, material_id, albedo, kind, fuzz, ior,
                      device=None) -> Scene:
    """The JAX `Scene` leaves as array-likes -> a Scene on `device`."""
    # np.array copies: arrays exported by JAX are read-only.
    return make_scene(*(np.array(a) for a in (
        centers, radii, material_id, albedo, kind, fuzz, ior)), device=device)


def scene_to_arrays(scene: Scene):
    """Scene -> the seven leaf arrays `scene_from_arrays` takes, as numpy."""
    m = scene.materials
    return tuple(t.detach().cpu().numpy() for t in (
        scene.centers, scene.radii, scene.material_id, m.albedo, m.kind,
        m.fuzz, m.ior))


def camera_from_arrays(origin, u, v, w, half_width, half_height, lens_radius,
                       focus_dist, device=None) -> Camera:
    """The JAX `Camera` leaves as array-likes -> a Camera on `device`."""
    return Camera.from_packed(np.concatenate([
        np.asarray(a, np.float32).reshape(-1) for a in (
            origin, u, v, w, half_width, half_height, lens_radius,
            focus_dist)]), device=device)


def scene_from_reference(scene, device=None) -> Scene:
    """A `bevy_raytrace_tpu` Scene -> the same Scene here."""
    m = scene.materials
    return scene_from_arrays(scene.centers, scene.radii, scene.material_id,
                             m.albedo, m.kind, m.fuzz, m.ior, device=device)


def camera_from_reference(camera, device=None) -> Camera:
    """A `bevy_raytrace_tpu` Camera -> the same Camera here (via pack())."""
    return Camera.from_packed(np.asarray(camera.pack()), device=device)


def cluster_plan_from_reference(plan) -> ClusterPlan:
    """A `bevy_raytrace_tpu.kernels.clusters.ClusterPlan` -> the same plan
    here (its three numpy arrays copied, its two sizes)."""
    return ClusterPlan(perm=np.array(plan.perm, np.int32),
                       member_mask=np.array(plan.member_mask, np.float32),
                       prio=np.array(plan.prio, np.int32),
                       cluster_size=int(plan.cluster_size),
                       n_clusters=int(plan.n_clusters))


def params_from_reference(params, device=None):
    """An `InverseProblem` parameter dict of the JAX package ({name: array})
    -> {name: float32 tensor on `device`}."""
    device = resolve(device)
    return {n: torch.tensor(np.array(v, np.float32), device=device)
            for n, v in params.items()}


def params_to_arrays(params):
    """{name: tensor} -> {name: numpy array}, for either package."""
    return {n: t.detach().cpu().numpy() for n, t in params.items()}


def residuals_from_reference(res, num_pixels: int, device=None):
    """Residuals of the JAX recorders (int16/int32 [spp, depth, P >=
    num_pixels]) -> an int tensor [spp, depth, num_pixels] on `device`.

    The JAX recorders pad the pixel axis to whole tiles.  For a stripe
    recorded with `num_local`, pass `num_pixels=num_local`: the stripe's
    [spp, depth, p_pad_local] comes back as [:, :, :num_local], the layout
    the port's stripe-mode K3 reads."""
    device = resolve(device)
    r = np.array(res)
    if r.dtype not in (np.int16, np.int32):
        raise TypeError(f"residuals must be int16 or int32, got {r.dtype}")
    return torch.from_numpy(
        np.ascontiguousarray(r[:, :, :num_pixels])).to(device)
