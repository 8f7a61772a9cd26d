"""Fast differentiable rendering: a recording forward (K2 or K4) and a
replay backward (K3) with no sphere search.

Mirror of `bevy_raytrace_tpu/inverse/fast_grad.py`.

  forward   K2 (`kernels/record.py`, forward="pallas") or K4
            (`kernels/sweep_record.py`, forward="sweep") renders the image
            and records, per (sample, bounce, pixel), the index of the
            sphere the path hit (-1 = miss), plus the runner-up when
            `edge_softness > 0`.
  backward  the recorded paths are replayed WITHOUT any nearest-hit search:
            the winner is read from the residual, its exact `t` recomputed
            in closed form, the same PCG4D counters replay the same random
            numbers.  `backward="kernel"` runs K3 (`kernels/replay_grad.py`),
            whose adjoint is derived by hand; `backward="torch"` takes
            autograd of `replay_paths` below (the reference's "xla").

Gradient semantics are the wavefront's straight-through policy: discrete
events (winner, hit/miss, root, material branch, Schlick choice,
scatter_ok) are frozen at their sampled values; continuous quantities
differentiate through; `edge_softness` adds the two-sided soft-silhouette
term, which only involves the hit sphere and the recorded runner-up.

Deliberate divergences from the reference: an unsupported combination of
options raises instead of being ignored (the reference silently drops
`forward="sweep"` when `grad_spp_chunk > 0`).  With `clusters=` K2 culls
its sphere loop but still records SCENE indices (`kernels/record.py`), so
the replay reads the unpermuted table with or without a plan: the
reference's `_permuted_table` is `_scene_table` here, and K3 takes no
`sphere_perm`.

Spans (`utils/spans.py`, while a profiler runs): `inverse.record` covers a
render of `make_fast_renderer`'s function (the table gather, `Camera.pack`,
the recorder's host side, with a plan its cluster bounds, and its launch);
`inverse.replay` covers the backward of that render (the replay's host side
and launch, and the cotangents' reduction).  Autograd's gather of the table
cotangent to the scene's leaves runs after it, outside both.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from bevy_raytrace_tpu_torch.config import RenderConfig
from bevy_raytrace_tpu_torch.core.geometry import sphere_table
from bevy_raytrace_tpu_torch.kernels.clusters import check_plan
from bevy_raytrace_tpu_torch.kernels.common import (
    _inv_sqrt_guard,
    _plain_camera,
    _scatter_vector,
)
from bevy_raytrace_tpu_torch.rng.pcg import uniform4
from bevy_raytrace_tpu_torch.utils.spans import span
from bevy_raytrace_tpu_torch.wavefront.render import frame_seed

# Above this many stored bounce-state bytes the replay is checkpointed per
# bounce instead of stored (~40 float32 of live state per path per bounce).
_REMAT_BYTES = 4 << 30


def _guarded_sqrt_k(kk):
    """The refraction sqrt with no gradient below k = 1e-12 (the TIR
    edge)."""
    kk_ok = kk > 1e-12
    return torch.where(kk_ok, torch.sqrt(torch.where(kk_ok, kk, 1.0)),
                       torch.sqrt(kk).detach())


def _replay_bounce(carry, b, pixel_ids, sample_ids, seed, sidx, sidx2, tbl,
                   config: RenderConfig):
    """One replayed (intersect-from-residual -> shade) round on component
    planes, operation for operation K3's `hit_forward`."""
    (ox, oy, oz, dx, dy, dz, tp_r, tp_g, tp_b, rad_r, rad_g, rad_b,
     alive) = carry
    where = torch.where
    hit = (sidx >= 0) & alive
    g = tbl[torch.clamp(sidx, min=0)]
    cx, cy, cz, r = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
    kind, fuzz, ior = g[:, 7], g[:, 8], g[:, 9]

    # Exact nearest t of the recorded winner, centered quadratic.  Double
    # guard on the sqrt: masked misses, and recorded winners whose replayed
    # disc <= 0 (a tangency the recorder's arithmetic saw as a hit) take
    # sq = 0 with no gradient through it.
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    hb = ocx * dx + ocy * dy + ocz * dz
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    cq = oc2 - r * r
    disc = hb * hb - cq
    pos = hit & (disc > 0.0)
    sq = where(pos, torch.sqrt(where(pos, disc, 1.0)), 0.0)
    rn = -hb - sq
    t_safe = where(hit, where(rn > config.t_min, rn, sq - hb), 0.0)
    hx, hy, hz = ox + t_safe * dx, oy + t_safe * dy, oz + t_safe * dz
    inv_r = 1.0 / where(r == 0.0, 1.0, r)
    owx = where(hit, (hx - cx) * inv_r, 0.0)
    owy = where(hit, (hy - cy) * inv_r, 0.0)
    owz = where(hit, (hz - cz) * inv_r, 1.0)
    front = (dx * owx + dy * owy + dz * owz) < 0.0
    sgn = where(front, 1.0, -1.0)
    nx, ny, nz = owx * sgn, owy * sgn, owz * sgn

    # ---- scatter (every model, selected by kind) -----------------------
    vx, vy, vz, is_lam, is_met = _scatter_vector(
        dx, dy, dz, nx, ny, nz, front, kind, fuzz, ior,
        uniform4(pixel_ids, sample_ids, b, seed), sqrt_k=_guarded_sqrt_k)
    q = _inv_sqrt_guard(vx * vx + vy * vy + vz * vz)
    sx, sy, sz = vx * q, vy * q, vz * q
    scat_ok = ~is_met | ((sx * nx + sy * ny + sz * nz) > 0.0)
    is_die = ~is_lam & ~is_met
    at_r = where(is_die, 1.0, g[:, 4])
    at_g = where(is_die, 1.0, g[:, 5])
    at_b = where(is_die, 1.0, g[:, 6])

    # ---- sky on a miss, silhouette term, throughput ---------------------
    tsky = 0.5 * (dy + 1.0)
    sk_r = 1.0 - 0.5 * tsky
    sk_g = 1.0 - 0.3 * tsky
    add = alive & ~hit
    rad_r = rad_r + where(add, tp_r * sk_r, 0.0)
    rad_g = rad_g + where(add, tp_g * sk_g, 0.0)
    rad_b = rad_b + where(add, tp_b, 0.0)
    scattered = alive & hit
    if config.edge_softness > 0.0:
        # Two-sided straight-through soft silhouette: st == 1 in value;
        # gradients gain ds * (L_path - L_bg), L_bg the recorded runner-up's
        # albedo (held constant) times the sky, or the sky.
        b_perp2 = oc2 - hb * hb
        r2 = torch.clamp(r * r, min=1e-12)
        edge_m2 = where(hit, 1.0 - b_perp2 / r2, 1.0)
        s_soft = torch.sigmoid(edge_m2 / config.edge_softness)
        st = 1.0 + (s_soft - s_soft.detach())
        at_r, at_g, at_b = at_r * st, at_g * st, at_b * st
        hit2 = sidx2 >= 0
        g2 = tbl[torch.clamp(sidx2, min=0)].detach()
        omt = where(scattered, 1.0 - st, 0.0)
        rad_r = rad_r + omt * tp_r * where(hit2, g2[:, 4] * sk_r, sk_r)
        rad_g = rad_g + omt * tp_g * where(hit2, g2[:, 5] * sk_g, sk_g)
        rad_b = rad_b + omt * tp_b * where(hit2, g2[:, 6], 1.0)
    tp_r = where(scattered, tp_r * at_r, tp_r)
    tp_g = where(scattered, tp_g * at_g, tp_g)
    tp_b = where(scattered, tp_b * at_b, tp_b)
    alive_next = scattered & scat_ok
    return (where(alive_next, hx, ox), where(alive_next, hy, oy),
            where(alive_next, hz, oz), where(alive_next, sx, dx),
            where(alive_next, sy, dy), where(alive_next, sz, dz),
            tp_r, tp_g, tp_b, rad_r, rad_g, rad_b, alive_next)


def replay_paths(camera, config: RenderConfig, pixel_ids, sample_ids, seed,
                 res_db, tbl, remat: bool = True, res2_db=None):
    """Differentiable re-trace of recorded paths -> radiance [K, 3].

    Scene cotangents flow only through `tbl` (a `sphere_table`, built by the
    caller), camera cotangents through `camera.pack()`.  res_db: int16/int32
    [max_depth, K] winner sphere index per bounce (-1 miss).  res2_db: the
    runner-ups, required when `config.edge_softness > 0`.  `remat`:
    checkpoint each bounce (`torch.utils.checkpoint`) instead of storing its
    intermediates.

    The arithmetic is K3's, operation for operation (component planes, no
    fused multiply-add, correctly rounded divisions and square roots), so
    that on the card the kernel replays exactly the paths this replays: a
    last-ulp difference could flip a discrete choice (a grazing metal
    bounce's scatter_ok, a tangent hit) and change a path's whole gradient."""
    if config.edge_softness > 0.0 and res2_db is None:
        raise ValueError(
            "edge_softness > 0 requires runner-up residuals (res2) — "
            "record the forward with record_second=True")
    ox, oy, oz, dx, dy, dz = _plain_camera(camera.pack(), pixel_ids,
                                           sample_ids, seed, config.width,
                                           config.height, _inv_sqrt_guard)
    one = torch.ones_like(ox)
    zero = torch.zeros_like(ox)
    carry = (ox, oy, oz, dx, dy, dz, one, one, one, zero, zero, zero,
             torch.ones_like(ox, dtype=torch.bool))
    remat = remat and torch.is_grad_enabled()
    for b in range(config.max_depth):
        sidx = res_db[b].long()
        sidx2 = None if res2_db is None else res2_db[b].long()
        args = (carry, b, pixel_ids, sample_ids, seed, sidx, sidx2, tbl,
                config)
        carry = (checkpoint(_replay_bounce, *args, use_reentrant=False,
                            preserve_rng_state=False)
                 if remat else _replay_bounce(*args))
    return torch.stack(carry[9:12], dim=1)


def _replay_sum(camera, config: RenderConfig, res, tbl, seed: int,
                sample_base: int = 0, res2=None, remat=None,
                pixel_base: int = 0, num_local=None):
    """Sum over the recorded samples of the replayed radiance -> [P, 3];
    the pixels are [pixel_base, pixel_base + num_local), the whole frame
    when `num_local` is None."""
    num_pixels = config.num_pixels if num_local is None else num_local
    spp = config.samples_per_pixel
    if remat is None:
        remat = spp * config.max_depth * num_pixels * 40 * 4 > _REMAT_BYTES
    pixel_ids = torch.arange(pixel_base, pixel_base + num_pixels,
                             dtype=torch.int64, device=tbl.device)
    fb = torch.zeros((num_pixels, 3), dtype=torch.float32, device=tbl.device)
    for s in range(spp):
        fb = fb + replay_paths(
            camera, config, pixel_ids, sample_base + s, seed,
            res[s, :, :num_pixels], tbl, remat=remat,
            res2_db=None if res2 is None else res2[s, :, :num_pixels])
    return fb


def _scene_table(scene):
    """`sphere_table` of the scene, with autograd (the reference's
    `_permuted_table` with no cluster plan)."""
    return sphere_table(scene.centers, scene.radii, scene.materials,
                        scene.material_id)


def replay_image(scene, camera, config: RenderConfig, res, frame: int = 0,
                 remat=None, res2=None):
    """Differentiable image from recorded residuals -> [H, W, 3].

    res: int16/int32 [spp, max_depth, P] with P >= num_pixels.  `remat`:
    None = checkpoint each bounce only when storing its state would exceed
    4 GiB; True/False forces.  `res2`: the runner-ups, required when
    `config.edge_softness > 0`."""
    fb = _replay_sum(camera, config, res, _scene_table(scene),
                     frame_seed(config, frame), 0, res2, remat)
    fb = fb / config.samples_per_pixel
    return fb.reshape(config.height, config.width, 3)


@dataclasses.dataclass(frozen=True)
class _Spec:
    """What one fast renderer runs.  `pixel_base`/`num_local` put recorder
    and replay into stripe mode (the image is then the flat [num_local, 3]
    stripe); `reduce(d_table, d_cam)` sums the stripe's cotangents over the
    ranks (`inverse/shard_grad.py`)."""

    config: RenderConfig
    backward: str
    chunk: int
    record_second: bool
    forward: str = "pallas"
    clusters: Optional[object] = None
    pixel_base: Optional[int] = None
    num_local: Optional[int] = None
    reduce: Optional[Callable] = None


def _record(spec: _Spec, table, cam16, config: RenderConfig, frame: int,
            sample_base: int = 0, with_residuals: bool = True):
    """The spec's recorder on its stripe -> (img, res, res2)."""
    stripe = dict(pixel_base=spec.pixel_base, num_local=spec.num_local)
    if spec.forward == "sweep":
        from bevy_raytrace_tpu_torch.kernels.sweep_record import (
            sweep_record_frame,
        )

        return sweep_record_frame(table, cam16, config, frame, sample_base,
                                  spec.record_second, **stripe)
    from bevy_raytrace_tpu_torch.kernels.record import record_frame

    return record_frame(table, cam16, config, frame, sample_base,
                        with_residuals,
                        spec.record_second and with_residuals,
                        clusters=spec.clusters, **stripe)


class _FastRender(torch.autograd.Function):
    """Image of (table [S, 11], cam16 [16]); backward -> (d_table, d_cam).

    Autograd carries d_table on through `sphere_table`'s gather to centers,
    radii, albedo, fuzz and ior, and d_cam through `Camera.pack`."""

    @staticmethod
    def forward(ctx, table, cam16, spec: _Spec, frame: int):
        # With a chunk, value only: the backward re-records each sample
        # chunk.
        img, res, res2 = _record(spec, table, cam16, spec.config, frame,
                                 with_residuals=not spec.chunk)
        ctx.spec, ctx.frame = spec, frame
        ctx.residuals = (res, res2)
        ctx.save_for_backward(table, cam16)
        return img

    @staticmethod
    def backward(ctx, g):
        with span("inverse.replay"):
            return _FastRender._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        from bevy_raytrace_tpu_torch.kernels.replay_grad import (
            replay_grad,
            replay_grad_plain,
        )

        table, cam16 = ctx.saved_tensors
        spec, frame = ctx.spec, ctx.frame
        g = g.contiguous()
        stripe = dict(pixel_base=spec.pixel_base, num_local=spec.num_local)
        if not spec.chunk:
            res, res2 = ctx.residuals
            replay = (replay_grad if spec.backward == "kernel"
                      else replay_grad_plain)
            d_tbl, d_cam = replay(table, cam16, spec.config, res, g, frame,
                                  res2=res2, **stripe)
            if spec.reduce is not None:
                d_tbl, d_cam = spec.reduce(d_tbl, d_cam)
            return d_tbl, d_cam, None, None
        # img = sum_c (chunk/spp) img_c and replay_grad folds 1/chunk: scale
        # g so that each chunk's path counts 1/spp.
        spp = spec.config.samples_per_pixel
        cfg = spec.config.replace(samples_per_pixel=spec.chunk, spp_chunk=1)
        g_scaled = g * (spec.chunk / spp)
        d_tbl = d_cam = None
        for base in range(0, spp, spec.chunk):
            _, res, res2 = _record(spec, table, cam16, cfg, frame, base)
            dt, dc = replay_grad(table, cam16, cfg, res, g_scaled, frame,
                                 sample_base=base, res2=res2, **stripe)
            del res, res2
            d_tbl = dt if d_tbl is None else d_tbl + dt
            d_cam = dc if d_cam is None else d_cam + dc
        if spec.reduce is not None:
            d_tbl, d_cam = spec.reduce(d_tbl, d_cam)
        return d_tbl, d_cam, None, None


def _check_options(config: RenderConfig, backward: str, grad_spp_chunk: int,
                   forward: str, clusters):
    """The option checks `make_fast_renderer` and its sharded form share."""
    if backward not in ("kernel", "torch"):
        raise ValueError(f"unknown backward {backward!r}")
    if forward not in ("pallas", "sweep"):
        raise ValueError(f"unknown forward {forward!r}")
    if forward == "sweep" and clusters is not None:
        raise ValueError(
            "forward='sweep' records in the unpermuted scene order: cluster "
            "plans do not apply")
    if clusters is not None:
        check_plan(clusters)
    if grad_spp_chunk:
        if forward == "sweep":
            raise ValueError(
                "forward='sweep' has no chunked form: grad_spp_chunk "
                "re-records with K2 (forward='pallas') only")
        if backward != "kernel":
            raise ValueError("grad_spp_chunk requires backward='kernel'")
        if config.samples_per_pixel % grad_spp_chunk:
            raise ValueError(
                f"samples_per_pixel={config.samples_per_pixel} must be "
                f"divisible by grad_spp_chunk={grad_spp_chunk}")


def make_fast_renderer(config: RenderConfig, backward: str = "kernel",
                       grad_spp_chunk: int = 0, forward: str = "pallas",
                       clusters=None):
    """A differentiable `render(scene, camera, frame=0) -> image [H, W, 3]`
    whose forward is K2 (or K4) and whose backward replays the recorded
    paths.

    `backward`: "kernel" (default) runs K3; "torch" replays in PyTorch and
    lets autograd transpose it (the plain version K3 is tested against),
    checkpointing each bounce above a memory threshold.

    `grad_spp_chunk` (backward="kernel" only): > 0 bounds the residual
    checkpoint to that many samples at a time: the forward records nothing
    (value only) and the backward re-records each chunk of samples and runs
    K3 on it, summing the cotangents.  The gradient equals the unchunked
    one up to float32 summation order; the cost is one more forward.

    `forward`: "pallas" records with K2 (the reference's default: the
    per-sphere loop on the expanded quadratic); "sweep" records with K4
    (the dense sweep on the centered quadratic, K1's; residuals in the
    unpermuted scene order).  The backward is the same either way.
    "sweep" with `grad_spp_chunk` or with `clusters` raises ValueError.

    `clusters`: a `kernels.clusters.ClusterPlan` of the scene's sphere count
    makes K2 cull its sphere loop by the plan's clusters (bounds from the
    live geometry on every render); the recorded paths, and so the
    gradient, are those of the brute-force loop up to exact ties."""
    _check_options(config, backward, grad_spp_chunk, forward, clusters)
    spec = _Spec(config, backward, grad_spp_chunk,
                 config.edge_softness > 0.0, forward, clusters)

    def render_fast(scene, camera, frame: int = 0):
        with span("inverse.record"):
            return _FastRender.apply(_scene_table(scene).contiguous(),
                                     camera.pack().contiguous(), spec,
                                     int(frame))

    return render_fast
