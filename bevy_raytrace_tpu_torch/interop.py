"""Carry scenes and cameras across from the JAX package as plain arrays.

The two packages share no objects; what one builds reaches the other as
numpy arrays, so tests can feed both exactly the same scene and camera.
Nothing here imports JAX: the `*_from_reference` helpers read the JAX
objects' fields through `np.asarray`.
"""

from __future__ import annotations

import numpy as np

from bevy_raytrace_tpu_torch.core.camera import Camera
from bevy_raytrace_tpu_torch.core.types import Scene, make_scene


def scene_from_arrays(centers, radii, material_id, albedo, kind, fuzz, ior,
                      device="cpu") -> Scene:
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
                       focus_dist, device="cpu") -> Camera:
    """The JAX `Camera` leaves as array-likes -> a Camera on `device`."""
    return Camera.from_packed(np.concatenate([
        np.asarray(a, np.float32).reshape(-1) for a in (
            origin, u, v, w, half_width, half_height, lens_radius,
            focus_dist)]), device=device)


def scene_from_reference(scene, device="cpu") -> Scene:
    """A `bevy_raytrace_tpu` Scene -> the same Scene here."""
    m = scene.materials
    return scene_from_arrays(scene.centers, scene.radii, scene.material_id,
                             m.albedo, m.kind, m.fuzz, m.ior, device=device)


def camera_from_reference(camera, device="cpu") -> Camera:
    """A `bevy_raytrace_tpu` Camera -> the same Camera here (via pack())."""
    return Camera.from_packed(np.asarray(camera.pack()), device=device)
