"""Sphere scenes from a configuration's `scene` block and a seed, made on
the device in a few large calls of a seeded `torch.Generator`.

The block describes a ground sphere, a jittered grid of small spheres with a
material mix, and a list of fixed "hero" spheres (the RTiOW final scene and
the upstream Bevy demo's variant of it).  Every sphere gets its own row of
the material table.

The layout (positions, material kinds, metal fuzz) is drawn from the
block's own `layout_seed`, the colours from the run's seed.  Path lengths,
and so the work of a frame, follow the layout and never the colours: on the
card, runs of one seed differed by ~0.3% and runs of six seeds with seeded
layouts by ~3%, so a seeded layout would have measured the layout.  Within
a layout, the grid's kinds are a permutation of exact shares of the mix, and
a jittered center that falls inside the keep-out ball is drawn again
instead of dropped, so the counts are the configuration's.
"""

from __future__ import annotations

import torch

from brtbench.reference import SceneArrays

KINDS = {"lambertian": 0, "metallic": 1, "dielectric": 2}
_MAX_REDRAWS = 1000


def grid_kind_counts(n: int, mix: dict) -> list:
    """Exact counts of each kind (lambertian, metallic, dielectric) among n
    grid spheres: each share rounded, the remainder to the last kind."""
    counts = [round(n * float(mix.get(k, 0.0))) for k in KINDS]
    counts[-1] = n - sum(counts[:-1])
    if min(counts) < 0:
        raise ValueError(f"material mix {mix} does not fit {n} spheres")
    return counts


def _material_row(m: dict):
    kind = KINDS[m["kind"]]
    albedo = m.get("albedo", [1.0, 1.0, 1.0])
    return albedo, kind, float(m.get("fuzz", 0.0)), float(m.get("ior", 1.5))


def build(spec: dict, seed: int, device) -> SceneArrays:
    """The scene of `spec` (a configuration's `scene` block) for `seed`."""
    dev = torch.device(device)
    f32 = torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(spec["layout_seed"]))
    colour = torch.Generator(device=dev)
    colour.manual_seed(int(seed))

    def rand(*shape, g=gen):
        return torch.rand(shape, generator=g, device=dev, dtype=f32)

    grid = spec["grid"]
    a0, a1 = grid["a"]
    b0, b1 = grid["b"]
    aa, bb = torch.meshgrid(torch.arange(a0, a1, device=dev, dtype=f32),
                            torch.arange(b0, b1, device=dev, dtype=f32),
                            indexing="ij")
    aa, bb = aa.reshape(-1), bb.reshape(-1)
    n = aa.shape[0]
    jitter, y = float(grid["jitter"]), float(grid["y"])
    ko = torch.tensor(grid["keep_out"]["center"], dtype=f32, device=dev)
    ko_d = float(grid["keep_out"]["distance"])

    def centers_of(u):
        return torch.stack([aa + jitter * u[:, 0], torch.full_like(aa, y),
                            bb + jitter * u[:, 1]], dim=1)

    u = rand(n, 2)
    for _ in range(_MAX_REDRAWS):
        bad = torch.linalg.norm(centers_of(u) - ko, dim=1) <= ko_d
        if not bool(bad.any()):
            break
        u = torch.where(bad[:, None], rand(n, 2), u)
    else:
        raise RuntimeError("keep-out redraws did not converge")
    centers = centers_of(u)

    counts = grid_kind_counts(n, grid["mix"])
    kinds = torch.cat([torch.full((c,), k, dtype=torch.int32, device=dev)
                       for k, c in zip(KINDS.values(), counts)])
    kinds = kinds[torch.randperm(n, generator=gen, device=dev)]

    fuzz = float(grid["metallic_fuzz_max"]) * rand(n)
    lam_rule = grid["lambertian_albedo"]
    lam = (rand(n, 3, g=colour) * rand(n, 3, g=colour)
           if lam_rule == "product" else rand(n, 3, g=colour))
    lo, hi = grid["metallic_albedo"]
    met = lo + (hi - lo) * rand(n, 3, g=colour)
    albedo = torch.where((kinds == 1)[:, None], met,
                         torch.where((kinds == 0)[:, None], lam, 1.0))
    fuzz = torch.where(kinds == 1, fuzz, 0.0)
    ior = torch.full((n,), float(grid.get("dielectric_ior", 1.5)), dtype=f32,
                     device=dev)

    fixed = [spec["ground"]] + list(spec["heroes"])
    rows = [_material_row(s["material"]) for s in fixed]
    f_centers = torch.tensor([s["center"] for s in fixed], dtype=f32,
                             device=dev)
    f_radii = torch.tensor([s["radius"] for s in fixed], dtype=f32, device=dev)
    f_albedo = torch.tensor([r[0] for r in rows], dtype=f32, device=dev)
    f_kind = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
    f_fuzz = torch.tensor([r[2] for r in rows], dtype=f32, device=dev)
    f_ior = torch.tensor([r[3] for r in rows], dtype=f32, device=dev)

    def order(fixed_t, grid_t):  # ground, grid, heroes
        return torch.cat([fixed_t[:1], grid_t, fixed_t[1:]])

    radius = torch.full((n,), float(grid["radius"]), dtype=f32, device=dev)
    total = n + len(fixed)
    return SceneArrays(
        centers=order(f_centers, centers).contiguous(),
        radii=order(f_radii, radius).contiguous(),
        material_id=torch.arange(total, dtype=torch.int32, device=dev),
        albedo=order(f_albedo, albedo).contiguous(),
        kind=order(f_kind, kinds).contiguous(),
        fuzz=order(f_fuzz, fuzz).contiguous(),
        ior=order(f_ior, ior).contiguous())

