"""Scene builders: the BASELINE configs and the reference's exact scene.

Mirror of `bevy_raytrace_tpu/scenes/builders.py`.  Scene randomness is
numpy's `default_rng(seed)` drawn in the same order, so every array equals
the JAX package's bit for bit.
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
