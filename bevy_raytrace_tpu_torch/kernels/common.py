"""Helpers shared by the kernels' plain PyTorch twins.

Mirror of the helpers `bevy_raytrace_tpu/kernels/pallas_render.py` gives
its kernels (`_pcg4d`, `_to_unit`, `_rsqrt_guard`, `_cbrt`, `_TWO_PI`), plus
the kernels' camera ray and shading step on component planes
(`_plain_camera`, `_scatter_vector`, `_plain_scatter`), which the twins of
K1 and K2 and the differentiable replay (K3's twin) share.  Their CUDA
counterparts live in `csrc/common.cuh`; keep the two in step.

Also the table modes of the dense-sweep kernels K1 and K4: the rule that
stages the sphere rows in shared memory or reads them through the read-only
cache (`forward_table_plan`, a pure function of the row count and a limit),
and the limit each kernel's library reports for this device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bevy_raytrace_tpu_torch.kernels import build
from bevy_raytrace_tpu_torch.rng.pcg import TWO_PI as _TWO_PI
from bevy_raytrace_tpu_torch.rng.pcg import _to_unit_float as _to_unit
from bevy_raytrace_tpu_torch.rng.pcg import pcg4d as _pcg4d
from bevy_raytrace_tpu_torch.wavefront.render import CAMERA_STREAM

__all__ = ["_pcg4d", "_to_unit", "_rsqrt_guard", "_inv_sqrt_guard", "_cbrt",
           "_TWO_PI", "_plain_camera", "_scatter_vector", "_plain_scatter",
           "FORWARD_TABLE_MODES", "FORWARD_ROW_BYTES", "FORWARD_MIN_BLOCKS",
           "forward_table_plan", "check_table_mode", "forward_table_mode"]

# K1's and K4's table modes, in the launchers' numbering (0, 1).
FORWARD_TABLE_MODES = ("global", "shared")
# Bytes of a staged sphere row: (cx, cy, cz, r^2) float32.
FORWARD_ROW_BYTES = 16
# Blocks of 128 threads an SM must keep resident for the staged table to
# pay, by library: below that the sweep's latency is less hidden than the
# read-only cache costs.  On an H100 both modes were timed on seeded scenes
# at the largest table each count of resident blocks admits (`git show
# e88e2a1:PERF.md`; `python -m bevy_raytrace_tpu_torch.tools.forward_kernels`
# times them again).  Staged against device memory: K1 0.5-2.4% faster at 7
# blocks (2,000 rows), 1.6-2.2% slower at 6 (2,368), 7-11% slower at 5; K4
# 5.6-6.7% faster at 7, 1.2-2.7% faster at 6, 1.8-4.3% slower at 5.  So K1
# stages up to 32,256 bytes (2,016 rows) and K4 up to 37,888 (2,368), with
# 56 registers a thread.  The libraries turn the count into bytes with the
# occupancy API.
# K1's culled kernel (rows, chunk bounds and priority rows staged) keeps
# K1's count: its own threshold is not timed yet.  Its warps' pair queues
# (13,312 bytes of static shared memory a block) are counted by the
# occupancy API, so its limit is that much lower.
FORWARD_MIN_BLOCKS = {"k1_render": 7, "k1_render_culled": 7,
                      "k4_sweep_record": 6}
# Kernel -> (library, its limit query).
_LIMIT_QUERIES = {
    "k1_render": ("k1_render", "brt_k1_table_bytes_limit"),
    "k1_render_culled": ("k1_render", "brt_k1_culled_table_bytes_limit"),
    "k4_sweep_record": ("k4_sweep_record", "brt_k4_table_bytes_limit"),
}


def _rsqrt_guard(n2):
    return torch.rsqrt(torch.clamp(n2, min=1e-20))


def _inv_sqrt_guard(n2):
    """1 / sqrt(max(n2, 1e-20)), correctly rounded in two steps (K3's
    `inv_sqrt_guard`, where K1 and K2 take rsqrtf)."""
    return 1.0 / torch.sqrt(torch.clamp(n2, min=1e-20))


def _cbrt(v):
    """Positive-domain cube root as exp(log(v)/3): the kernels' form."""
    return torch.where(
        v < 1e-30, 0.0,
        torch.exp(torch.log(torch.clamp(v, min=1e-30)) * (1.0 / 3.0)))


def _plain_camera(cam, pid, sample, seed, width, height,
                  inv_norm=_rsqrt_guard):
    """The kernels' thin-lens camera ray on component planes (common.cuh
    `camera_ray`): cam is `Camera.pack()`'s [16], pid the absolute pixel
    ids.  `inv_norm` is the guarded 1/|t| of the direction: `_rsqrt_guard`
    for K1 and K2, `_inv_sqrt_guard` for K3.  Returns (ox, oy, oz, dx, dy,
    dz), differentiable in cam."""
    (cox, coy, coz, ux, uy, uz, vx, vy, vz, wx, wy, wz, half_w, half_h,
     lens_r, focus) = cam.unbind(0)
    cu1, cu2, cu3, cu4 = (_to_unit(v) for v in
                          _pcg4d(pid, sample, CAMERA_STREAM, seed))
    px = (pid % width).to(torch.float32)
    py = (pid // width).to(torch.float32)
    # 0-d tensors on pid's device: a true division, as the kernels divide.
    # On CUDA, torch turns `x / python_scalar` into a reciprocal multiply.
    fw = torch.tensor(float(width), device=pid.device)
    fh = torch.tensor(float(height), device=pid.device)
    s_im = (px + cu1) / fw
    t_im = 1.0 - (py + cu2) / fh
    ru = torch.sqrt(cu3)
    phi = _TWO_PI * cu4
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


def _scatter_vector(dx, dy, dz, nx, ny, nz, front, kind, fuzz, ior, u,
                    sqrt_k=torch.sqrt):
    """The kernels' scatter direction BEFORE normalizing, on component
    planes: every material model for every lane, selected by kind (0
    Lambertian, 1 metal, 2 dielectric).

    `u` holds the four bounce uniforms.  `sqrt_k` takes the refraction's
    sqrt(|1 - pp.pp|); the replay passes one whose gradient is guarded.
    Returns (vx, vy, vz, is_lam, is_met)."""
    where = torch.where
    u1, u2, u3, u4 = u
    zs = 1.0 - 2.0 * u1
    rs = torch.sqrt(torch.clamp(1.0 - zs * zs, min=0.0))
    ph = _TWO_PI * u2
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
    sqk = sqrt_k(torch.abs(1.0 - (ppx * ppx + ppy * ppy + ppz * ppz)))
    ex = where(refl, rx, ppx - sqk * nx)
    ey = where(refl, ry, ppy - sqk * ny)
    ez = where(refl, rz, ppz - sqk * nz)

    is_lam = kind < 0.5
    is_met = (kind > 0.5) & (kind < 1.5)
    return (where(is_lam, lx, where(is_met, mx, ex)),
            where(is_lam, ly, where(is_met, my, ey)),
            where(is_lam, lz, where(is_met, mz, ez)), is_lam, is_met)


def _plain_scatter(dx, dy, dz, nx, ny, nz, front, kind, fuzz, ior, u):
    """K1's and K2's scatter (common.cuh `scatter`): `_scatter_vector`
    normalized with rsqrt.  Returns (sx, sy, sz, is_die, scat_ok): the new
    unit direction, the dielectric mask (attenuation 1 there, the albedo
    elsewhere) and scatter_ok."""
    vx, vy, vz, is_lam, is_met = _scatter_vector(dx, dy, dz, nx, ny, nz,
                                                 front, kind, fuzz, ior, u)
    q = _rsqrt_guard(vx * vx + vy * vy + vz * vz)
    sx, sy, sz = vx * q, vy * q, vz * q
    return (sx, sy, sz, ~is_lam & ~is_met,
            ~is_met | ((sx * nx + sy * ny + sz * nz) > 0.0))


# --- the table modes of K1 and K4 ----------------------------------------


def forward_table_plan(n_rows: int, limit_bytes: int):
    """The table mode of K1 or K4 for `n_rows` sphere rows -> (mode, bytes
    of dynamic shared memory a block takes): ("shared", n_rows *
    FORWARD_ROW_BYTES) when that fits `limit_bytes` (what the kernel's
    library reports, `brt_k1_table_bytes_limit` / `brt_k4_table_bytes_limit`:
    the most a block may stage while the kernel's FORWARD_MIN_BLOCKS blocks
    stay resident on an SM), else ("global", 0)."""
    if n_rows < 0 or limit_bytes < 0:
        raise ValueError(f"n_rows={n_rows} and limit_bytes={limit_bytes} "
                         f"must be >= 0")
    nbytes = n_rows * FORWARD_ROW_BYTES
    return ("shared", nbytes) if nbytes <= limit_bytes else ("global", 0)


def check_table_mode(table_mode):
    """A wrapper's `table_mode` argument: None (the plan's) or one of
    FORWARD_TABLE_MODES; anything else raises before any launch."""
    if table_mode is not None and table_mode not in FORWARD_TABLE_MODES:
        raise ValueError(f"table_mode must be None or one of "
                         f"{FORWARD_TABLE_MODES}, got {table_mode!r}")
    return table_mode


@functools.lru_cache(maxsize=None)
def _table_limit(name: str, index: int) -> int:
    """The table-limit query of kernel `name` (`_LIMIT_QUERIES`) on CUDA
    device `index`, for its FORWARD_MIN_BLOCKS."""
    library, query = _LIMIT_QUERIES[name]
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = getattr(build.load(library), query)(
            FORWARD_MIN_BLOCKS[name], ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"{name}'s shared-memory query failed with "
                           f"cudaError_t {err}")
    return out.value


def forward_table_mode(name: str, device, n_rows: int, table_mode=None):
    """The table mode a launch of kernel `name` ("k1_render",
    "k1_render_culled", "k4_sweep_record") on CUDA `device` takes:
    `table_mode` when given (the checks on the card force one; the launcher
    refuses a shared table that does not fit a block), else
    `forward_table_plan`'s for `n_rows` staged rows."""
    if check_table_mode(table_mode) is not None:
        return table_mode
    index = device.index
    return forward_table_plan(n_rows, _table_limit(
        name, torch.cuda.current_device() if index is None else index))[0]
