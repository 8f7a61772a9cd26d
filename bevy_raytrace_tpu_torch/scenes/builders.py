"""Scene builders: the BASELINE configs and the reference's exact scene.

Mirror of `bevy_raytrace_tpu/scenes/builders.py`.  Scene randomness is
numpy's `default_rng(seed)` drawn in the same order, so every array equals
the JAX package's bit for bit.  The SPD sphereflake (`sphereflake_scene`)
is the port's own: the reference builds no such scene.
"""

from __future__ import annotations

import numpy as np

from bevy_raytrace_tpu_torch.core.camera import Camera
from bevy_raytrace_tpu_torch.core.types import Scene, make_scene
from bevy_raytrace_tpu_torch.scenes.registry import MaterialRegistry


def _build(spheres, registry: MaterialRegistry, device) -> Scene:
    """spheres: list of (center, radius, material_index)."""
    centers = np.array([s[0] for s in spheres], np.float32)
    radii = np.array([s[1] for s in spheres], np.float32)
    mats = np.array([s[2] for s in spheres], np.int32)
    m = registry.to_materials(device)
    return make_scene(centers, radii, mats, m.albedo, m.kind, m.fuzz, m.ior,
                      device=device)


# --- BASELINE config 1: single Lambertian sphere + ground ------------------


def baseline_config1_scene(device=None):
    reg = MaterialRegistry()
    ground = reg.lambertian("ground", (0.5, 0.5, 0.5))
    ball = reg.lambertian("ball", (0.7, 0.3, 0.3))
    spheres = [
        ((0.0, -100.5, -1.0), 100.0, ground),
        ((0.0, 0.0, -1.0), 0.5, ball),
    ]
    return _build(spheres, reg, device), reg


def baseline_config1_camera(aspect, device=None):
    return Camera.look_at(lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0),
                          vfov_deg=90.0, aspect=aspect, aperture=0.0,
                          focus_dist=1.0, device=device)


# --- BASELINE config 2: lambertian + metal + dielectric --------------------


def baseline_config2_scene(device=None):
    reg = MaterialRegistry()
    ground = reg.lambertian("ground", (0.8, 0.8, 0.0))
    center = reg.lambertian("center", (0.1, 0.2, 0.5))
    left = reg.dielectric("left", ior=1.5)
    right = reg.metallic("right", (0.8, 0.6, 0.2), fuzz=0.0)
    spheres = [
        ((0.0, -100.5, -1.0), 100.0, ground),
        ((0.0, 0.0, -1.0), 0.5, center),
        ((-1.0, 0.0, -1.0), 0.5, left),
        # Hollow glass: negative radius flips the normal inward.
        ((-1.0, 0.0, -1.0), -0.45, left),
        ((1.0, 0.0, -1.0), 0.5, right),
    ]
    return _build(spheres, reg, device), reg


def baseline_config2_camera(aspect, device=None):
    return Camera.look_at(lookfrom=(-2.0, 2.0, 1.0), lookat=(0.0, 0.0, -1.0),
                          vfov_deg=20.0, aspect=aspect, aperture=0.0,
                          device=device)


# --- BASELINE config 3: RTiOW final (book-cover) scene ---------------------


def rtiow_final_scene(seed: int = 0, grid: int = 11, device=None):
    """~480 spheres: ground + jittered grid + three heroes.

    Grid material mix per RTiOW: 80% diffuse (albedo = rand*rand),
    15% metal (albedo in [0.5,1], fuzz in [0,0.5)), 5% glass (ior 1.5).
    """
    rng = np.random.default_rng(seed)
    reg = MaterialRegistry()
    spheres = []

    ground = reg.lambertian("ground", (0.5, 0.5, 0.5))
    spheres.append(((0.0, -1000.0, 0.0), 1000.0, ground))

    for a in range(-grid, grid):
        for b in range(-grid, grid):
            center = (a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random())
            if np.linalg.norm(np.array(center) - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            choose = rng.random()
            name = f"material_{a}_{b}"
            if choose < 0.8:
                albedo = rng.random(3) * rng.random(3)
                mat = reg.lambertian(name, tuple(albedo))
            elif choose < 0.95:
                albedo = 0.5 + 0.5 * rng.random(3)
                mat = reg.metallic(name, tuple(albedo), fuzz=0.5 * rng.random())
            else:
                mat = reg.dielectric(name, ior=1.5)
            spheres.append((center, 0.2, mat))

    glass = reg.dielectric("hero_glass", ior=1.5)
    diffuse = reg.lambertian("hero_diffuse", (0.4, 0.2, 0.1))
    metal = reg.metallic("hero_metal", (0.7, 0.6, 0.5), fuzz=0.0)
    spheres.append(((0.0, 1.0, 0.0), 1.0, glass))
    spheres.append(((-4.0, 1.0, 0.0), 1.0, diffuse))
    spheres.append(((4.0, 1.0, 0.0), 1.0, metal))

    return _build(spheres, reg, device), reg


def rtiow_final_camera(aspect, device=None):
    """RTiOW final viewpoint: (13,2,3) looking at the origin."""
    return Camera.look_at(lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
                          vfov_deg=20.0, aspect=aspect, aperture=0.1,
                          focus_dist=10.0, device=device)


# --- The reference's exact scene variant -----------------------------------


def reference_scene(seed: int = 0, device=None):
    """The scene the reference renderer actually builds (14x14 grid, no
    dielectrics), with its startup material palette and registry insertion
    order (ground, center, left, right, then grid materials)."""
    rng = np.random.default_rng(seed)
    reg = MaterialRegistry()
    ground = reg.lambertian("ground", (0.5, 0.5, 0.5))
    center = reg.lambertian("center", (0.7, 0.3, 0.3))
    left = reg.metallic("left", (0.8, 0.8, 0.8), fuzz=0.1)
    right = reg.metallic("right", (0.7, 0.6, 0.5), fuzz=0.0)

    spheres = [((0.0, -1000.0, -1.0), 1000.0, ground)]
    for a in range(-7, 7):
        for b in range(-7, 7):
            c = (a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random())
            if np.linalg.norm(np.array(c) - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            name = f"material_{a}_{b}"
            if rng.random() < 0.8:
                mat = reg.lambertian(name, tuple(rng.random(3)))
            else:
                mat = reg.metallic(name, tuple(rng.random(3)), fuzz=0.5 * rng.random())
            spheres.append((c, 0.2, mat))

    spheres.append(((0.0, 1.0, 0.0), 1.0, center))
    spheres.append(((-4.0, 1.0, 0.0), 1.0, left))
    spheres.append(((4.0, 1.0, 0.0), 1.0, right))
    return _build(spheres, reg, device), reg


# --- Seeded scenes of any size (the port's own; no reference builds them) ---


def random_scene(n, seed=0, device=None):
    """A seeded scene of `n` spheres: the RTiOW ground and n - 1 small
    spheres of mixed materials scattered over it, denser than
    rtiow_final's (tables up to and above a block's shared memory)."""
    rng = np.random.default_rng(seed)
    m = n - 1
    r = rng.uniform(0.05, 0.25, m)
    xz = rng.uniform(-11.0, 11.0, (m, 2))
    centers = np.concatenate([[[0.0, -1000.0, 0.0]],
                              np.stack([xz[:, 0], r, xz[:, 1]], 1)])
    return make_scene(
        centers, np.concatenate([[1000.0], r]), np.arange(n),
        np.concatenate([[[0.5, 0.5, 0.5]], rng.uniform(0.1, 0.9, (m, 3))]),
        np.concatenate([[0], rng.choice(3, m, p=[0.7, 0.2, 0.1])]),
        np.concatenate([[0.0], rng.uniform(0.0, 0.5, m)]),
        np.full(n, 1.5), device=device)


# --- The SPD sphereflake (the port's own; no reference builds it) ----------

# Directions of a sphere's nine children about +z: six on the equator every
# 60 degrees, three at 60 degrees of elevation every 120 degrees from 30.
_FLAKE_EQUATOR_DEG = (0, 60, 120, 180, 240, 300)
_FLAKE_ELEVATED_DEG = (30, 150, 270)
_FLAKE_ELEVATION_DEG = 60.0


def _flake_directions():
    eq = [(np.cos(np.radians(a)), np.sin(np.radians(a)), 0.0)
          for a in _FLAKE_EQUATOR_DEG]
    el = np.radians(_FLAKE_ELEVATION_DEG)
    up = [(np.cos(el) * np.cos(np.radians(a)),
           np.cos(el) * np.sin(np.radians(a)), np.sin(el))
          for a in _FLAKE_ELEVATED_DEG]
    return np.array(eq + up)


def _turn_from_z(axis):
    """The least rotation that takes +z to the unit `axis` (Rodrigues'
    formula); for an axis within 1e-9 of -z in 1 + z, the half turn about
    +y."""
    c = axis[2]
    if 1.0 + c < 1e-9:
        return np.diag([-1.0, 1.0, -1.0])
    k = np.array([[0.0, 0.0, axis[0]], [0.0, 0.0, axis[1]],
                  [-axis[0], -axis[1], 0.0]])  # [z x axis]_x
    return np.eye(3) + k + k @ k / (1.0 + c)


def sphereflake_scene(level: int = 4, device=None):
    """Eric Haines' sphereflake from the Standard Procedural Databases (SPD,
    IEEE CG&A 7(11), 1987; `balls.c` at size factor 4 for level 4):
    1 + 9 + ... + 9^level mirror spheres (7,381 at level 4) over SPD's
    ground, here a Lambertian sphere of radius 1000 whose top is SPD's
    ground plane.

    Built in SPD's z-up frame, then turned into the port's y-up one by
    (x, y, z) -> (x, z, -y), a rigid turn.  The top sphere has center 0,
    radius 0.5 and axis +z.  Each sphere of radius r and axis a down to
    `level` has nine children of radius r / 3 that touch it: the child's
    center is c + w (r + r / 3), its axis w, for w the directions
    `_flake_directions` turned by the least rotation that takes +z to a
    (`_turn_from_z`).  balls.c's own direction set is not in the
    repository; this one is its shape (36 of the level-4 flake's pairs
    overlap).  The ground comes first, then the flake level by level, each
    level's children in their parents' order.  Every flake sphere is metal
    with fuzz 0, albedo (0.8, 0.6, 0.26); the ground is Lambertian 0.5."""
    if level < 0:
        raise ValueError(f"level must be >= 0, got {level}")
    dirs = _flake_directions()
    centers, radii = [np.zeros(3)], [0.5]
    todo = [(np.zeros(3), 0.5, np.array([0.0, 0.0, 1.0]))]
    for _ in range(level):
        nxt = []
        for c, r, a in todo:
            for w in dirs @ _turn_from_z(a).T:
                nxt.append((c + w * (r + r / 3.0), r / 3.0, w))
        centers += [t[0] for t in nxt]
        radii += [t[1] for t in nxt]
        todo = nxt
    xyz = np.array(centers)
    up = np.stack([xyz[:, 0], xyz[:, 2], -xyz[:, 1]], axis=1)  # y up
    reg = MaterialRegistry()
    ground = reg.lambertian("ground", (0.5, 0.5, 0.5))
    flake = reg.metallic("flake", (0.8, 0.6, 0.26), fuzz=0.0)
    spheres = [((0.0, -1000.5, 0.0), 1000.0, ground)]
    spheres += [(tuple(c), r, flake) for c, r in zip(up, radii)]
    return _build(spheres, reg, device), reg


def sphereflake_camera(aspect, device=None):
    """SPD's sphereflake view in the port's y-up frame: from (2.1, 1.3, 1.7)
    z-up, i.e. (2.1, 1.7, -1.3), at the origin, 45 degrees, a pinhole."""
    return Camera.look_at(lookfrom=(2.1, 1.7, -1.3), lookat=(0.0, 0.0, 0.0),
                          vfov_deg=45.0, aspect=aspect, aperture=0.0,
                          device=device)
