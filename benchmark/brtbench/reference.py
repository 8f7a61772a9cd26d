"""The plain reference: a path tracer of sphere scenes in plain PyTorch.

It computes what the program's render path computes (the RTiOW thin-lens
camera, Lambertian, metal and dielectric scatter, the sky gradient, the
PCG4D counter-based RNG keyed on (absolute pixel id, sample, stream, frame
seed)), with plain tensor operations and no kernel, from the benchmark's own
scene arrays and camera poses.  It imports nothing of the program: its
scene tables, camera bases and frame seeds are worked out here again.

The arithmetic follows the order of the port's K1 kernel (the centered
quadratic, rsqrt-normalized directions, the first index winning a tie), as
a frozen copy of that kernel's published semantics, so two sound runs
differ only where a rounding flips a discrete choice on a rare path.

`dtype` sets the precision of every floating-point plane; the control runs
it at bfloat16, the precision below the float32 the configurations state.
"""

from __future__ import annotations

import dataclasses
import math

import torch

MASK32 = 0xFFFFFFFF
_MUL = 1664525
_ADD = 1013904223
_INV_2POW24 = 1.0 / 16777216.0
TWO_PI = 6.2831854820251465  # float32(2 pi)
CAMERA_STREAM = 0x9E3779B9
FRAME_MIX = 0x85EBCA6B
T_MIN = 1.0e-3
# Elements of the [lanes, spheres] workspace one chunk of lanes may take.
WORKSPACE = {"cpu": 1 << 22, "cuda": 1 << 26}


def frame_seed(base_seed: int, frame: int) -> int:
    """The 32-bit RNG counter of `frame` for a scene rendered at `base_seed`."""
    return (int(base_seed) + FRAME_MIX * int(frame)) & MASK32


# --- PCG4D on int64 tensors holding 32-bit values -------------------------


def _mul32(a, b):
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def pcg4d(x, y, z, w):
    """Four 32-bit counters (int64 tensors or ints, broadcast) -> four
    32-bit hashes as int64 tensors."""
    dev = next(v.device for v in (x, y, z, w) if isinstance(v, torch.Tensor))
    x, y, z, w = (torch.as_tensor(v, dtype=torch.int64, device=dev) & MASK32
                  for v in (x, y, z, w))
    x = (x * _MUL + _ADD) & MASK32
    y = (y * _MUL + _ADD) & MASK32
    z = (z * _MUL + _ADD) & MASK32
    w = (w * _MUL + _ADD) & MASK32
    x = (x + _mul32(y, w)) & MASK32
    y = (y + _mul32(z, x)) & MASK32
    z = (z + _mul32(x, y)) & MASK32
    w = (w + _mul32(y, z)) & MASK32
    x, y, z, w = x ^ (x >> 16), y ^ (y >> 16), z ^ (z >> 16), w ^ (w >> 16)
    x = (x + _mul32(y, w)) & MASK32
    y = (y + _mul32(z, x)) & MASK32
    z = (z + _mul32(x, y)) & MASK32
    w = (w + _mul32(y, z)) & MASK32
    return x, y, z, w


def uniforms(pid, sample, stream, seed, dtype):
    """Four uniforms in [0, 1) from the top 24 bits of each hash."""
    return [((v >> 8).to(torch.float32) * _INV_2POW24).to(dtype)
            for v in pcg4d(pid, sample, stream, seed)]


# --- scene and camera -----------------------------------------------------


@dataclasses.dataclass
class SceneArrays:
    """A sphere scene as the benchmark makes it: centers [S,3], radii [S],
    material_id [S] int, and the material table albedo [M,3], kind [M]
    (0 Lambertian, 1 metal, 2 dielectric), fuzz [M], ior [M]."""

    centers: torch.Tensor
    radii: torch.Tensor
    material_id: torch.Tensor
    albedo: torch.Tensor
    kind: torch.Tensor
    fuzz: torch.Tensor
    ior: torch.Tensor

    @property
    def count(self) -> int:
        return int(self.centers.shape[0])

    def to(self, device):
        return SceneArrays(**{f.name: getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)})


def tables(scene: SceneArrays, dtype=torch.float32):
    """Per-sphere planes: (cx, cy, cz, r^2) and (1/r, albedo rgb, kind,
    fuzz, ior), in `dtype`.  1/r keeps the radius' sign (hollow glass)."""
    c = scene.centers.to(torch.float32)
    r = scene.radii.to(torch.float32)
    mid = scene.material_id.long()
    geom = torch.stack([c[:, 0], c[:, 1], c[:, 2], r * r], dim=1)
    attr = torch.stack([1.0 / r, scene.albedo[mid, 0], scene.albedo[mid, 1],
                        scene.albedo[mid, 2],
                        scene.kind[mid].to(torch.float32), scene.fuzz[mid],
                        scene.ior[mid]], dim=1)
    return geom.to(dtype), attr.to(dtype)


def _normalize(v):
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return v / torch.clamp(n, min=1e-12)


def look_at(lookfrom, lookat, vup, vfov_deg, aspect, aperture, focus_dist):
    """RTiOW thin-lens cameras -> packed float32 [F, 16]: origin, u, v, w,
    half width, half height, lens radius, focus distance.  lookfrom and
    lookat are [F, 3] float32 tensors; focus_dist None is |lookfrom -
    lookat|."""
    f32 = torch.float32
    dev = lookfrom.device
    lookfrom, lookat = lookfrom.to(f32), lookat.to(f32)
    n = lookfrom.shape[0]
    vup = torch.as_tensor(vup, dtype=f32, device=dev).expand(n, 3)
    if focus_dist is None:
        focus = torch.sqrt(torch.sum((lookfrom - lookat) ** 2, dim=-1))
    else:
        focus = torch.full((n,), float(focus_dist), dtype=f32, device=dev)
    theta = torch.tensor(float(vfov_deg), dtype=f32, device=dev) * (
        math.pi / 180.0)
    half_h = torch.tan(theta / 2.0).expand(n)
    half_w = half_h * torch.tensor(float(aspect), dtype=f32, device=dev)
    w = _normalize(lookfrom - lookat)
    u = _normalize(torch.linalg.cross(vup, w))
    v = torch.linalg.cross(w, u)
    lens = (torch.tensor(float(aperture), dtype=f32, device=dev) / 2.0
            ).expand(n)
    return torch.cat([lookfrom, u, v, w, half_w[:, None], half_h[:, None],
                      lens[:, None], focus[:, None]], dim=1)


# --- one bounce's pieces --------------------------------------------------


def _rsqrt_guard(n2):
    return torch.rsqrt(torch.clamp(n2, min=1e-20))


def _cbrt(v):
    return torch.where(
        v < 1e-30, 0.0,
        torch.exp(torch.log(torch.clamp(v, min=1e-30)) * (1.0 / 3.0)))


def _camera_rays(cam, pid, sample, seed, width, height, dtype):
    """Thin-lens camera rays; cam [n, 16] per lane, pid/sample/seed [n]."""
    (cox, coy, coz, ux, uy, uz, vx, vy, vz, wx, wy, wz, half_w, half_h,
     lens_r, focus) = cam.to(dtype).unbind(1)
    cu1, cu2, cu3, cu4 = uniforms(pid, sample, CAMERA_STREAM, seed, dtype)
    px = (pid % width).to(dtype)
    py = (pid // width).to(dtype)
    fw = torch.tensor(float(width), dtype=dtype, device=pid.device)
    fh = torch.tensor(float(height), dtype=dtype, device=pid.device)
    s_im = (px + cu1) / fw
    t_im = 1.0 - (py + cu2) / fh
    ru = torch.sqrt(cu3)
    phi = TWO_PI * cu4
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
    q = _rsqrt_guard(tx * tx + ty * ty + tz * tz)
    return ox, oy, oz, tx * q, ty * q, tz * q


def _root(gx, gy, gz, gr2, ox, oy, oz, dx, dy, dz):
    """Nearest root > t_min of rays (o, d) on spheres (g, gr2), broadcast;
    NaN on a miss."""
    ocx, ocy, ocz = ox - gx, oy - gy, oz - gz
    hb = ocx * dx + ocy * dy + ocz * dz
    cq = (ocx * ocx + ocy * ocy + ocz * ocz) - gr2
    disc = hb * hb - cq
    sq = disc * torch.rsqrt(disc)  # NaN where disc <= 0
    rn = -hb - sq
    return torch.where(rn > T_MIN, rn, sq - hb)


def _scatter(dx, dy, dz, nx, ny, nz, front, kind, fuzz, ior, u):
    """New unit direction, dielectric mask and scatter_ok of every lane."""
    where = torch.where
    u1, u2, u3, u4 = u
    zs = 1.0 - 2.0 * u1
    rs = torch.sqrt(torch.clamp(1.0 - zs * zs, min=0.0))
    ph = TWO_PI * u2
    rux, ruy, ruz = rs * torch.cos(ph), rs * torch.sin(ph), zs
    lx, ly, lz = nx + rux, ny + ruy, nz + ruz
    deg = (torch.abs(lx) + torch.abs(ly) + torch.abs(lz)) < 1e-8
    lx, ly, lz = where(deg, nx, lx), where(deg, ny, ly), where(deg, nz, lz)

    ddn = dx * nx + dy * ny + dz * nz
    rx = dx - 2.0 * ddn * nx
    ry = dy - 2.0 * ddn * ny
    rz = dz - 2.0 * ddn * nz
    fz = fuzz * _cbrt(u3)
    mx, my, mz = rx + fz * rux, ry + fz * ruy, rz + fz * ruz

    ratio = where(front, 1.0 / ior, ior)
    cos_t = torch.clamp(-(dx * nx + dy * ny + dz * nz), max=1.0)
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
    sqk = torch.sqrt(torch.abs(1.0 - (ppx * ppx + ppy * ppy + ppz * ppz)))
    ex = where(refl, rx, ppx - sqk * nx)
    ey = where(refl, ry, ppy - sqk * ny)
    ez = where(refl, rz, ppz - sqk * nz)

    is_lam = kind < 0.5
    is_met = (kind > 0.5) & (kind < 1.5)
    vx = where(is_lam, lx, where(is_met, mx, ex))
    vy = where(is_lam, ly, where(is_met, my, ey))
    vz = where(is_lam, lz, where(is_met, mz, ez))
    q = _rsqrt_guard(vx * vx + vy * vy + vz * vz)
    sx, sy, sz = vx * q, vy * q, vz * q
    return (sx, sy, sz, ~is_lam & ~is_met,
            ~is_met | ((sx * nx + sy * ny + sz * nz) > 0.0))


def _paths(geom, attr, cam, pid, sample, seed, max_depth, width, height,
           dtype):
    """Trace one path per lane -> (radiance [n, 3], rounds [n])."""
    where = torch.where
    gx, gy, gz, gr2 = geom.T.contiguous().unbind(0)
    ox, oy, oz, dx, dy, dz = _camera_rays(cam, pid, sample, seed, width,
                                          height, dtype)
    zero = torch.zeros(pid.shape, dtype=dtype, device=pid.device)
    acc_r, acc_g, acc_b = zero, zero, zero
    tp_r, tp_g, tp_b = zero + 1.0, zero + 1.0, zero + 1.0
    rounds = torch.zeros(pid.shape, dtype=torch.float32, device=pid.device)
    alive = torch.ones(pid.shape, dtype=torch.bool, device=pid.device)
    for bounce in range(max_depth):
        if bounce and not bool(alive.any()):
            break
        rounds = rounds + alive.to(torch.float32)
        tn = _root(gx, gy, gz, gr2, ox[:, None], oy[:, None], oz[:, None],
                   dx[:, None], dy[:, None], dz[:, None])
        tn = where(tn > T_MIN, tn, math.inf)
        best_t, best = torch.min(tn, dim=1)
        hit = best_t < math.inf

        bcx, bcy, bcz, br2 = geom[best].unbind(1)
        binv, bar, bag, bab, bkd, bfz, bio = attr[best].unbind(1)
        rocx, rocy, rocz = ox - bcx, oy - bcy, oz - bcz
        hb = rocx * dx + rocy * dy + rocz * dz
        cq = (rocx * rocx + rocy * rocy + rocz * rocz) - br2
        sq = torch.sqrt(torch.clamp(hb * hb - cq, min=0.0))
        rn = -hb - sq
        bt = where(rn > T_MIN, rn, sq - hb)
        t_safe = where(hit, bt, 0.0)
        hx, hy, hz = ox + t_safe * dx, oy + t_safe * dy, oz + t_safe * dz
        nx = where(hit, (hx - bcx) * binv, 0.0)
        ny = where(hit, (hy - bcy) * binv, 0.0)
        nz = where(hit, (hz - bcz) * binv, 1.0)
        front = (dx * nx + dy * ny + dz * nz) < 0.0
        sgn = where(front, 1.0, -1.0)
        nx, ny, nz = nx * sgn, ny * sgn, nz * sgn

        sx, sy, sz, is_die, scat_ok = _scatter(
            dx, dy, dz, nx, ny, nz, front, bkd, bfz, bio,
            uniforms(pid, sample, bounce, seed, dtype))

        tsky = 0.5 * (dy + 1.0)
        add = alive & ~hit
        acc_r = acc_r + where(add, tp_r * (1.0 - 0.5 * tsky), 0.0)
        acc_g = acc_g + where(add, tp_g * (1.0 - 0.3 * tsky), 0.0)
        acc_b = acc_b + where(add, tp_b, 0.0)
        scat = alive & hit
        tp_r = where(scat, tp_r * where(is_die, 1.0, bar), tp_r)
        tp_g = where(scat, tp_g * where(is_die, 1.0, bag), tp_g)
        tp_b = where(scat, tp_b * where(is_die, 1.0, bab), tp_b)
        alive = scat & scat_ok & (bounce + 1 < max_depth)
        ox, oy, oz = where(alive, hx, ox), where(alive, hy, oy), \
            where(alive, hz, oz)
        dx, dy, dz = where(alive, sx, dx), where(alive, sy, dy), \
            where(alive, sz, dz)
    return torch.stack([acc_r, acc_g, acc_b], dim=1), rounds


@torch.no_grad()
def render_pixels(scene: SceneArrays, cams, pids, seeds, spp: int,
                  max_depth: int, width: int, height: int,
                  dtype=torch.float32):
    """Render pixels one by one.

    cams [n, 16] (`look_at`'s layout), pids [n] absolute pixel ids and
    seeds [n] frame seed counters, one row per pixel to render; samples
    [0, spp).  Returns (image values [n, 3] float32: the samples summed in
    sample order, times float32(1/spp); rounds [n]: the (path, bounce)
    rounds the pixel's paths took, summed over its samples)."""
    dev = pids.device
    geom, attr = tables(scene, dtype)
    n = pids.shape[0]
    pid = pids.to(torch.int64).repeat_interleave(spp)
    smp = torch.arange(spp, dtype=torch.int64, device=dev).repeat(n)
    sd = seeds.to(torch.int64).repeat_interleave(spp)
    row = torch.arange(n, device=dev).repeat_interleave(spp)
    lanes = pid.shape[0]
    budget = WORKSPACE.get(dev.type, WORKSPACE["cpu"])
    chunk = max(budget // geom.shape[0], 128)
    rad = torch.empty((lanes, 3), dtype=dtype, device=dev)
    rounds = torch.empty((lanes,), dtype=torch.float32, device=dev)
    for lo in range(0, lanes, chunk):
        hi = min(lo + chunk, lanes)
        rad[lo:hi], rounds[lo:hi] = _paths(
            geom, attr, cams[row[lo:hi]], pid[lo:hi], smp[lo:hi], sd[lo:hi],
            max_depth, width, height, dtype)
    rad = rad.reshape(n, spp, 3)
    acc = torch.zeros((n, 3), dtype=dtype, device=dev)
    for s in range(spp):  # sample order, as a lane accumulates its samples
        acc = acc + rad[:, s]
    inv_spp = torch.tensor(1.0 / spp, dtype=torch.float32).item()
    return acc.to(torch.float32) * inv_spp, rounds.reshape(n, spp).sum(1)
