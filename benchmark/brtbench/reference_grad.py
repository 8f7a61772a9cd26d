"""The plain gradient reference: the image of a set of pixels of a sphere
scene, and the gradient with respect to the spheres' centers and the
materials' albedo of a pixel loss on them, in plain PyTorch.

For pixels p with weights w_p and target values t_p it computes the image
(the paths of `brtbench/reference.py`, the same bits) and the gradient of
the port's loss (`inverse/loss.py::render_loss`), the cross estimator of
two frames a and b (`cross_loss_grad`),

    L = sum_p w_p * (a_p - t_p) . (b_p - t_p)    (. over the channels),

or of one frame's L = sum_p w_p * |img_p - t_p|^2 (`loss_grad`), under
the straight-through policy the port publishes for its gradients
(`bevy_raytrace_tpu_torch/inverse/fast_grad.py`, `wavefront/render.py`):
the discrete events of a sampled path (the winner, hit or miss, the root,
the material branch, the Schlick choice, `scatter_ok`) are frozen at their
sampled values and the continuous quantities differentiate through; with
`edge_softness` > 0 the two-sided soft-silhouette term of the hit sphere
and its runner-up is added.  Per bounce of a path that hit its winner,
with oc the ray origin less the winner's center, hb = oc.d and
edge = 1 - (|oc|^2 - hb^2) / r^2:

    st  = 1 + (s - stop_gradient(s)),  s = sigmoid(edge / edge_softness)
    throughput *= albedo * st     (dielectrics: 1 * st)
    radiance   += (1 - st) * throughput * L_bg

where L_bg is the runner-up's albedo (held constant) times the sky along
the ray, or the sky where the ray has no runner-up.  st is 1 and 1 - st is
0 in value, so the image is the plain path tracer's.

It runs in two passes over chunks of lanes (a lane is one sample of one
pixel).  The first, with no autograd, traces every path, with a sweep of
every sphere that records each bounce's winner and runner-up, or along
winners and runner-ups given to it (`events`: a recorder's residuals, the
paths the program sampled); it gives the image, the rounds and the hit
bounces a path took.  The second replays the first pass's winners (no
sweep) with autograd on the sphere rows they gather, and takes the
gradient of sum(lane radiance * dL/dlane), dL/dlane = dL/dimg_p / spp
(2 w_p (img_p - t_p), or for frame a of the cross estimator w_p (b_p -
t_p), b's image held constant), summed over the chunks.  The other
discrete events are computed under `no_grad` from the same values, in the
same order, so the second pass takes the first pass's.

Why a gradient is compared on the program's own paths: a path whose
discrete choice rounds differently takes another path (K2's expanded
quadratic rounds |o - c|^2 - r^2 of a sphere of radius 0.2 at |o| ~ 10 to
~1e-5, and a grazing exit re-hits its own sphere or not by that rounding:
the two sweeps differ on 0.65% of the paths of the `rtiow_final` scene at
depth 8), and a path that grazes the ground or a silhouette
carries a gradient thousands of times a typical one.  On the port's own
CPU twins at 96 x 64 x 8 spp, one such path of 49,152 made 69% of the
ground's center gradient, and the two sweeps' center gradients differed by
91%; on the same recorded paths they agree to 6e-4.  So the sweep's paths
are compared with the recorded ones apart (the share of paths that
differ), and the gradient is taken on the recorded ones.  For the same
reason a check may take the loss's images (`image`, `images`) from the
recorder: along the same grazing paths its arithmetic rounds the image
apart from this replay's, and the pixel's weight in the loss with it (on
an H100 at 2 x 16,384 pixels x 64 samples, the cross estimator's
gradient read 0.003-0.076 off the program's with this pass's own images,
~1e-3 with the recorder's).

It imports nothing of the program, only brtbench/reference.py (scene
tables, PCG4D, camera, root, cube root), and computes in `dtype`: the
control runs it at bfloat16.  TF32 is off for both CUDA matmuls and cuDNN
(nothing here should take it; the flags make sure).

Departures from the published description, all deliberate:

- The sweep is the plain reference's: the centered quadratic, rsqrt-
  normalized directions, the first index winning a tie (K1's arithmetic),
  where the program records with K2's expanded quadratic.  The runner-up
  is K2's rule: the first-index nearest valid root strictly farther than
  the winner's.
- Along given events the arithmetic is the program's replay's (K3's, as
  its twin `inverse/fast_grad.py::replay_paths` writes it down): the
  winner's root from the centered quadratic, directions normalized by a
  correctly rounded 1/sqrt, no fma; the sweep normalizes with rsqrt, as
  K1 does.  A grazing path is ill-conditioned (a ray along the ground
  moves its hit point by 1/|d_y| times the ground's height), and on the
  card the two normalizations took such paths apart enough to leave the
  center gradient of 262,144 recorded paths 58% off K3's; in K3's
  arithmetic that of 1,048,576 paths was 3e-6 off.
- Sums are float32 autograd sums per chunk, summed over chunks in float32;
  K3 sums a frame's cotangents in float64.
- Only `centers` and `albedo` are differentiated: the camera, radii, fuzz
  and ior are held constant (the program also returns their cotangents).
- The refraction's sqrt(|1 - pp.pp|) has no gradient below 1e-12, and the
  root's sqrt none where the discriminant is not positive, as the port's
  replay guards them; both are where a path grazes (total internal
  reflection's edge, a tangent hit) and the derivative is unbounded.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from brtbench import reference as ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class Paths:
    """One pass over a set of pixels."""

    image: torch.Tensor  # [n, 3] float32 (float64 for a float64 pass)
    rounds: torch.Tensor  # [n] float32: (path, bounce) rounds, over samples
    hits: torch.Tensor  # [n] float32: bounces that hit a sphere
    events: torch.Tensor  # int32 [depth, 2, n * spp]: winner, runner-up


def events_of(res, res2, pids):
    """A recorder's residuals (res, res2: [spp, depth, P] scene indices,
    -1 for none) at pixels `pids` -> events [depth, 2, n * spp], lanes
    pixel-major as `trace_pixels` orders them."""
    out = []
    for r in (res, res2):
        r = r[:, :, pids].to(torch.int32)  # [spp, depth, n]
        out.append(r.permute(1, 2, 0).reshape(r.shape[1], -1))
    return torch.stack(out, dim=1)


def paths_differ(a, b):
    """[lanes] bool: the lanes whose winner or runner-up differs at some
    bounce between events `a` and `b`."""
    return (a != b).any(dim=1).any(dim=0)


def _lanes(pids, seeds, spp):
    """(pixel id, sample, frame seed, row) of every lane, pixel-major."""
    dev = pids.device
    n = pids.shape[0]
    return (pids.to(torch.int64).repeat_interleave(spp),
            torch.arange(spp, dtype=torch.int64, device=dev).repeat(n),
            seeds.to(torch.int64).repeat_interleave(spp),
            torch.arange(n, device=dev).repeat_interleave(spp))


def _sweep(geom, ox, oy, oz, dx, dy, dz):
    """Winner and runner-up of every lane over every sphere, with no
    autograd -> (winner [n], hit [n], runner-up [n], -1 where none)."""
    gx, gy, gz, gr2 = geom.T.contiguous().unbind(0)
    tn = ref._root(gx, gy, gz, gr2, ox[:, None], oy[:, None], oz[:, None],
                   dx[:, None], dy[:, None], dz[:, None])
    tn = torch.where(tn > ref.T_MIN, tn, math.inf)
    best_t, best = torch.min(tn, dim=1)
    hit = best_t < math.inf
    t2, second = torch.min(torch.where(tn > best_t[:, None], tn, math.inf),
                           dim=1)
    second = torch.where(hit & (t2 < math.inf), second, -1)
    return best, hit, second


def _inv_sqrt_guard(n2):
    """1 / sqrt(max(n2, 1e-20)), correctly rounded in two steps: the
    replay's normalization (K3's), where the sweep's takes rsqrt."""
    return 1.0 / torch.sqrt(torch.clamp(n2, min=1e-20))


def _camera(cam, pid, sample, seed, width, height, dtype, inv_norm):
    """`reference._camera_rays`, operation for operation, with the
    direction's normalization `inv_norm`."""
    (cox, coy, coz, ux, uy, uz, vx, vy, vz, wx, wy, wz, half_w, half_h,
     lens_r, focus) = cam.to(dtype).unbind(1)
    cu1, cu2, cu3, cu4 = ref.uniforms(pid, sample, ref.CAMERA_STREAM, seed,
                                      dtype)
    px = (pid % width).to(dtype)
    py = (pid // width).to(dtype)
    fw = torch.tensor(float(width), dtype=dtype, device=pid.device)
    fh = torch.tensor(float(height), dtype=dtype, device=pid.device)
    s_im = (px + cu1) / fw
    t_im = 1.0 - (py + cu2) / fh
    ru = torch.sqrt(cu3)
    phi = ref.TWO_PI * cu4
    du = ru * torch.cos(phi) * lens_r
    dv = ru * torch.sin(phi) * lens_r
    ox = cox + du * ux + dv * vx
    oy = coy + du * uy + dv * vy
    oz = coz + du * uz + dv * vz
    su = (2.0 * s_im - 1.0) * half_w * focus
    tv = (2.0 * t_im - 1.0) * half_h * focus
    tx = cox - focus * wx + su * ux + tv * vx - ox
    ty = coy - focus * wy + su * uy + tv * vy - oy
    tz = coz - focus * wz + su * uz + tv * vz - oz
    q = inv_norm(tx * tx + ty * ty + tz * tz)
    return ox, oy, oz, tx * q, ty * q, tz * q


def _guarded_sqrt(v, ok):
    """sqrt(v) where `ok`, 0 elsewhere; no gradient where not `ok`."""
    return torch.where(ok, torch.sqrt(torch.where(ok, v, 1.0)), 0.0)


def _scatter(dx, dy, dz, nx, ny, nz, front, kind, fuzz, ior, u, inv_norm):
    """`reference._scatter`, operation for operation in value, with its
    discrete choices made under `no_grad`, its square roots guarded for
    autograd and the direction's normalization `inv_norm` -> (unit
    direction, dielectric mask, scatter_ok)."""
    where = torch.where
    u1, u2, u3, u4 = u
    zs = 1.0 - 2.0 * u1
    rs = torch.sqrt(torch.clamp(1.0 - zs * zs, min=0.0))
    ph = ref.TWO_PI * u2
    rux, ruy, ruz = rs * torch.cos(ph), rs * torch.sin(ph), zs
    lx, ly, lz = nx + rux, ny + ruy, nz + ruz
    with torch.no_grad():
        deg = (torch.abs(lx) + torch.abs(ly) + torch.abs(lz)) < 1e-8
    lx, ly, lz = where(deg, nx, lx), where(deg, ny, ly), where(deg, nz, lz)

    ddn = dx * nx + dy * ny + dz * nz
    rx = dx - 2.0 * ddn * nx
    ry = dy - 2.0 * ddn * ny
    rz = dz - 2.0 * ddn * nz
    fz = fuzz * ref._cbrt(u3)
    mx, my, mz = rx + fz * rux, ry + fz * ruy, rz + fz * ruz

    ratio = where(front, 1.0 / ior, ior)
    cos_t = torch.clamp(-(dx * nx + dy * ny + dz * nz), max=1.0)
    with torch.no_grad():
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        r0 = (1.0 - ratio) / (1.0 + ratio)
        r0 = r0 * r0
        m1 = 1.0 - cos_t
        m2 = m1 * m1
        schlick = r0 + (1.0 - r0) * (m2 * m2 * m1)
        refl = (ratio * sin_t > 1.0) | (schlick > u4)
    ppx = ratio * (dx + cos_t * nx)
    ppy = ratio * (dy + cos_t * ny)
    ppz = ratio * (dz + cos_t * nz)
    kk = torch.abs(1.0 - (ppx * ppx + ppy * ppy + ppz * ppz))
    sqk = torch.where(kk > 1e-12, _guarded_sqrt(kk, kk > 1e-12),
                      torch.sqrt(kk).detach())
    ex = where(refl, rx, ppx - sqk * nx)
    ey = where(refl, ry, ppy - sqk * ny)
    ez = where(refl, rz, ppz - sqk * nz)

    is_lam = kind < 0.5
    is_met = (kind > 0.5) & (kind < 1.5)
    vx = where(is_lam, lx, where(is_met, mx, ex))
    vy = where(is_lam, ly, where(is_met, my, ey))
    vz = where(is_lam, lz, where(is_met, mz, ez))
    q = inv_norm(vx * vx + vy * vy + vz * vz)
    sx, sy, sz = vx * q, vy * q, vz * q
    with torch.no_grad():
        ok = ~is_met | ((sx * nx + sy * ny + sz * nz) > 0.0)
    return sx, sy, sz, ~is_lam & ~is_met, ok


def _trace(centers, albedo, consts, cam, pid, sample, seed, max_depth,
           width, height, edge, dtype, events=None, replay=False):
    """One path per lane -> (radiance [n, 3], rounds [n], hits [n],
    events int32 [depth, 2, n]).

    centers [S, 3] and albedo [M, 3] may require grad; `consts` holds the
    sphere rows that do not (r^2, 1/r, material id, kind, fuzz, ior) and
    the sweep's geometry.  `events` None sweeps every sphere (no autograd);
    else each bounce's winner and runner-up are read from it.  `replay`:
    the replay's arithmetic (K3's normalizations), else the sweep's."""
    where = torch.where
    geom, r2, inv_r, mid, kind, fuzz, ior = consts
    inv_norm = _inv_sqrt_guard if replay else ref._rsqrt_guard
    c = centers.to(dtype)
    alb = albedo.to(dtype)
    with torch.no_grad():
        ox, oy, oz, dx, dy, dz = _camera(cam, pid, sample, seed, width,
                                         height, dtype, inv_norm)
    zero = torch.zeros(pid.shape, dtype=dtype, device=pid.device)
    acc_r, acc_g, acc_b = zero, zero, zero
    tp_r, tp_g, tp_b = zero + 1.0, zero + 1.0, zero + 1.0
    rounds = torch.zeros(pid.shape, dtype=torch.float32, device=pid.device)
    hits = torch.zeros_like(rounds)
    alive = torch.ones(pid.shape, dtype=torch.bool, device=pid.device)
    record = torch.full((max_depth, 2, pid.shape[0]), -1, dtype=torch.int32,
                        device=pid.device)
    if events is not None:
        record.copy_(events)
    for bounce in range(max_depth):
        if bounce and not bool(alive.any()):
            break
        rounds = rounds + alive.to(torch.float32)
        if events is None:
            with torch.no_grad():
                best, hit, second = _sweep(geom, ox, oy, oz, dx, dy, dz)
            record[bounce, 0] = torch.where(hit, best, -1).to(torch.int32)
            record[bounce, 1] = second.to(torch.int32)
        else:
            best = events[bounce, 0].long()
            second = events[bounce, 1].long()
            hit = best >= 0
            best = best.clamp(min=0)
        hits = hits + (alive & hit).to(torch.float32)

        bc = c[best]
        bcx, bcy, bcz = bc.unbind(1)
        br2, binv = r2[best], inv_r[best]
        m = mid[best]
        bar, bag, bab = alb[m].unbind(1)
        rocx, rocy, rocz = ox - bcx, oy - bcy, oz - bcz
        hb = rocx * dx + rocy * dy + rocz * dz
        oc2 = rocx * rocx + rocy * rocy + rocz * rocz
        cq = oc2 - br2
        disc = hb * hb - cq
        sq = _guarded_sqrt(disc, disc > 0.0)
        rn = -hb - sq
        with torch.no_grad():
            near = rn > ref.T_MIN
        bt = where(near, rn, sq - hb)
        t_safe = where(hit, bt, 0.0)
        hx, hy, hz = ox + t_safe * dx, oy + t_safe * dy, oz + t_safe * dz
        nx = where(hit, (hx - bcx) * binv, 0.0)
        ny = where(hit, (hy - bcy) * binv, 0.0)
        nz = where(hit, (hz - bcz) * binv, 1.0)
        with torch.no_grad():
            front = (dx * nx + dy * ny + dz * nz) < 0.0
        sgn = where(front, 1.0, -1.0)
        nx, ny, nz = nx * sgn, ny * sgn, nz * sgn

        sx, sy, sz, is_die, scat_ok = _scatter(
            dx, dy, dz, nx, ny, nz, front, kind[m], fuzz[m], ior[m],
            ref.uniforms(pid, sample, bounce, seed, dtype), inv_norm)

        tsky = 0.5 * (dy + 1.0)
        sk_r, sk_g = 1.0 - 0.5 * tsky, 1.0 - 0.3 * tsky
        add = alive & ~hit
        acc_r = acc_r + where(add, tp_r * sk_r, 0.0)
        acc_g = acc_g + where(add, tp_g * sk_g, 0.0)
        acc_b = acc_b + where(add, tp_b, 0.0)
        scat = alive & hit
        at_r = where(is_die, 1.0, bar)
        at_g = where(is_die, 1.0, bag)
        at_b = where(is_die, 1.0, bab)
        if edge > 0.0:
            edge_m2 = where(hit, 1.0 - (oc2 - hb * hb) / torch.clamp(
                br2, min=1e-12), 1.0)
            s_soft = torch.sigmoid(edge_m2 / edge)
            st = 1.0 + (s_soft - s_soft.detach())
            at_r, at_g, at_b = at_r * st, at_g * st, at_b * st
            hit2 = second >= 0
            a2 = alb[mid[second.clamp(min=0)]].detach()
            omt = where(scat, 1.0 - st, 0.0)
            acc_r = acc_r + omt * tp_r * where(hit2, a2[:, 0] * sk_r, sk_r)
            acc_g = acc_g + omt * tp_g * where(hit2, a2[:, 1] * sk_g, sk_g)
            acc_b = acc_b + omt * tp_b * where(hit2, a2[:, 2], 1.0)
        tp_r = where(scat, tp_r * at_r, tp_r)
        tp_g = where(scat, tp_g * at_g, tp_g)
        tp_b = where(scat, tp_b * at_b, tp_b)
        alive = scat & scat_ok & (bounce + 1 < max_depth)
        ox, oy, oz = where(alive, hx, ox), where(alive, hy, oy), \
            where(alive, hz, oz)
        dx, dy, dz = where(alive, sx, dx), where(alive, sy, dy), \
            where(alive, sz, dz)
    return torch.stack([acc_r, acc_g, acc_b], dim=1), rounds, hits, record


def _out(dtype):
    """The dtype of images and gradients: float32, or float64 for a pass
    in float64 (finite differences)."""
    return torch.promote_types(torch.float32, dtype)


def _consts(scene: ref.SceneArrays, dtype):
    geom, attr = ref.tables(scene, dtype)
    r = scene.radii.to(torch.float32)
    mid = scene.material_id.long()
    return (geom, (r * r).to(dtype), attr[:, 0], mid,
            scene.kind.to(torch.float32).to(dtype), scene.fuzz.to(dtype),
            scene.ior.to(dtype))


def _chunk(scene: ref.SceneArrays) -> int:
    budget = ref.WORKSPACE.get(scene.centers.device.type,
                               ref.WORKSPACE["cpu"])
    return max(budget // max(scene.count, 1), 128)


def trace_pixels(scene: ref.SceneArrays, cams, pids, seeds, spp: int,
                 max_depth: int, width: int, height: int,
                 dtype=torch.float32, events=None) -> Paths:
    """The first pass (no autograd): pixels `pids` [n] of cameras `cams`
    [n, 16] (`reference.look_at`'s layout) at frame seed counters `seeds`
    [n], samples [0, spp).  `events` [depth, 2, n * spp] replays those
    winners and runner-ups in place of the sweep, in the replay's
    arithmetic (K3's normalizations).  The image is the
    samples summed in sample order times float32(1/spp), as
    `reference.render_pixels`."""
    dev = pids.device
    n = pids.shape[0]
    pid, smp, sd, row = _lanes(pids, seeds, spp)
    lanes = pid.shape[0]
    consts = _consts(scene, dtype)
    chunk = _chunk(scene)
    rad = torch.empty((lanes, 3), dtype=dtype, device=dev)
    rounds = torch.empty((lanes,), dtype=torch.float32, device=dev)
    hits = torch.empty_like(rounds)
    record = torch.empty((max_depth, 2, lanes), dtype=torch.int32,
                         device=dev)
    with torch.no_grad():
        for lo in range(0, lanes, chunk):
            hi = min(lo + chunk, lanes)
            rad[lo:hi], rounds[lo:hi], hits[lo:hi], record[:, :, lo:hi] = \
                _trace(scene.centers, scene.albedo, consts, cams[row[lo:hi]],
                       pid[lo:hi], smp[lo:hi], sd[lo:hi], max_depth, width,
                       height, 0.0, dtype,
                       None if events is None else events[:, :, lo:hi],
                       events is not None)
    rad = rad.reshape(n, spp, 3)
    acc = torch.zeros((n, 3), dtype=dtype, device=dev)
    for s in range(spp):  # sample order, as a lane accumulates its samples
        acc = acc + rad[:, s]
    inv_spp = torch.tensor(1.0 / spp, dtype=torch.float32).item()
    return Paths(acc.to(_out(dtype)) * inv_spp,
                 rounds.reshape(n, spp).sum(1), hits.reshape(n, spp).sum(1),
                 record)


def _grad(scene: ref.SceneArrays, cams, pids, seeds, spp: int,
          max_depth: int, width: int, height: int, events, up_pix,
          edge_softness: float, dtype, replay: bool):
    """The second pass: the gradient of sum_p up_pix_p . img_p (up_pix
    [n, 3]) with respect to `scene.centers` and `scene.albedo`, along
    `events` (the first pass's), in the replay's arithmetic if `replay`
    -> (d_centers, d_albedo)."""
    pid, smp, sd, row = _lanes(pids, seeds, spp)
    inv_spp = torch.tensor(1.0 / spp, dtype=torch.float32).item()
    out = _out(dtype)
    up_lane = up_pix.to(out) * inv_spp
    consts = _consts(scene, dtype)
    chunk = _chunk(scene)
    centers = scene.centers.detach().to(out).requires_grad_(True)
    albedo = scene.albedo.detach().to(out).requires_grad_(True)
    d_c = torch.zeros_like(centers)
    d_a = torch.zeros_like(albedo)
    with torch.enable_grad():
        for lo in range(0, pid.shape[0], chunk):
            hi = min(lo + chunk, pid.shape[0])
            rad, _, _, _ = _trace(
                centers, albedo, consts, cams[row[lo:hi]], pid[lo:hi],
                smp[lo:hi], sd[lo:hi], max_depth, width, height,
                float(edge_softness), dtype, events[:, :, lo:hi], replay)
            up = up_lane[row[lo:hi]].to(dtype)
            gc, ga = torch.autograd.grad((rad * up).sum(), (centers, albedo),
                                         allow_unused=True)
            if gc is not None:
                d_c = d_c + gc.to(out)
            if ga is not None:
                d_a = d_a + ga.to(out)
    return d_c, d_a


def loss_grad(scene: ref.SceneArrays, cams, pids, seeds, spp: int,
              max_depth: int, width: int, height: int, target, weights,
              edge_softness: float, dtype=torch.float32, events=None,
              image=None):
    """The image of pixels `pids` and the gradient of
    sum_p weights_p |img_p - target_p|^2 (target [n, 3], weights [n]) with
    respect to `scene.centers` and `scene.albedo`, on the paths of the
    sweep, or with `events` on those recorded paths.  `image` [n, 3]: the
    img_p of dL/dimg_p, when not this pass's own (a recorder's image of
    the same paths, which its arithmetic rounds apart: to hold a
    program's gradient of its own image's loss).

    Returns (paths, d_centers [S, 3], d_albedo [M, 3]), the gradients
    float32 (float64 for a float64 pass)."""
    paths = trace_pixels(scene, cams, pids, seeds, spp, max_depth, width,
                         height, dtype, events)
    out = _out(dtype)
    img = paths.image if image is None else image.to(out)
    up = 2.0 * weights.to(out)[:, None] * (img - target.to(out))
    d_c, d_a = _grad(scene, cams, pids, seeds, spp, max_depth, width,
                     height, paths.events, up, edge_softness, dtype,
                     events is not None)
    return paths, d_c, d_a


def cross_loss_grad(scene: ref.SceneArrays, cams, pids, seeds, spp: int,
                    max_depth: int, width: int, height: int, target,
                    weights, edge_softness: float, dtype=torch.float32,
                    events=None, images=None):
    """The port's loss (`inverse/loss.py::render_loss`, the two-sample
    cross estimator) on pixels `pids` of two frames: seeds = (seeds_a,
    seeds_b), each [n], and `events` None (the sweep's paths) or
    (events_a, events_b) (recorded paths).  The gradient, with respect to
    `scene.centers` and `scene.albedo`, is that of

        L = sum_p weights_p (a_p - target_p) . (b_p - target_p),

    each frame's part taken with the other frame's image held constant.
    `images` (a, b), each [n, 3]: the a_p and b_p of dL/dimg, when not
    this pass's own (as `loss_grad`'s `image`).

    Returns (paths_a, paths_b, d_centers [S, 3], d_albedo [M, 3])."""
    pa, pb = (trace_pixels(scene, cams, pids, s, spp, max_depth, width,
                           height, dtype, e)
              for s, e in zip(seeds, events or (None, None)))
    out = _out(dtype)
    w, t = weights.to(out)[:, None], target.to(out)
    img_a, img_b = (pa.image, pb.image) if images is None else (
        im.to(out) for im in images)
    d_c = d_a = 0.0
    for paths, s, other in ((pa, seeds[0], img_b), (pb, seeds[1], img_a)):
        gc, ga = _grad(scene, cams, pids, s, spp, max_depth, width, height,
                       paths.events, w * (other - t), edge_softness, dtype,
                       events is not None)
        d_c, d_a = d_c + gc, d_a + ga
    return pa, pb, d_c, d_a
