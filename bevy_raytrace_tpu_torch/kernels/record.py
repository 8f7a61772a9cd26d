"""K2, the recording forward of the fast gradient path: its wrapper, its
plain PyTorch twin, its host side.

`record_frame` is the wrapper of the CUDA kernel `csrc/k2_record.cu`, which
replaces `bevy_raytrace_tpu/kernels/pallas_render.py::_make_kernel` (the
TPU's v1 forward kernel, launched by `render_pallas`) in its recording form.
Alongside the image it writes, per (sample, bounce, pixel), the index of the
sphere the path hit (-1 = miss, or the path was already dead) and, with
`record_second`, the runner-up: the complete checkpoint of a sampled path's
discrete choices, which the replay backward (`kernels/replay_grad.py`) reads
instead of searching the spheres again.  On CUDA tensors it launches the
kernel or raises; on CPU tensors it runs `record_frame_plain`, the twin in
this module that computes the same thing with tensor ops.

Host side, by the reference's names: `render_pallas(..., with_residuals=True)`
-> `render_record`, with `render_record_plain` beside it.  Residuals are
int16 when the sphere count fits 15 bits (`pallas_render.py:723`), else int32,
shaped [spp, max_depth, num_pixels].

Not ported (each raises, see ROADMAP.md): the cluster-culled broad phase
(`clusters=`), stripe mode (`pixel_base`, `num_local`).  The TPU tiling
options (tile_rows, unroll, skip_dead_tiles) do not exist here.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from bevy_raytrace_tpu_torch.config import RenderConfig
from bevy_raytrace_tpu_torch.core.geometry import sphere_table
from bevy_raytrace_tpu_torch.kernels import build
from bevy_raytrace_tpu_torch.kernels.common import (
    _pcg4d,
    _plain_camera,
    _plain_scatter,
    _to_unit,
)
from bevy_raytrace_tpu_torch.kernels.render_lanes import _check
from bevy_raytrace_tpu_torch.wavefront.render import frame_seed

# Residuals are int16 up to this many sphere slots, int32 above.
INT16_SLOTS = 32767
# Float elements of one [lanes, spheres] temporary in the twin's sweep.
_PLAIN_WORKSPACE = {"cpu": 1 << 22, "cuda": 1 << 26}
_LANES = 128


def residual_dtype(n_spheres: int) -> torch.dtype:
    """The residual dtype for a scene of `n_spheres`."""
    return torch.int16 if n_spheres <= INT16_SLOTS else torch.int32


def _record_tables(table):
    """[S, 11] `sphere_table` -> (geom [S', 4], attr [S', 8]) float32.

    geom row: (cx, cy, cz, |c|^2 - r^2), the expanded quadratic's per-sphere
    constant.  attr row: (1/r, albedo r, g, b, kind, fuzz, ior, 0); 1/r keeps
    the radius sign (hollow glass).  An empty scene gets one row that no ray
    can hit (|c|^2 - r^2 = 1e30), as the reference pads its sphere loop."""
    if table.shape[0] == 0:
        geom = table.new_tensor([[0.0, 0.0, 0.0, 1e30]])
        return geom, table.new_tensor([[1.0, 0, 0, 0, 0, 0, 1.0, 0]])
    cx, cy, cz, r = table[:, 0], table[:, 1], table[:, 2], table[:, 3]
    geom = torch.stack([cx, cy, cz, (cx * cx + cy * cy + cz * cz) - r * r], 1)
    attr = torch.cat([(1.0 / r)[:, None], table[:, 4:10],
                      torch.zeros_like(r)[:, None]], dim=1)
    return geom.contiguous(), attr.contiguous()


# --- the plain twin -----------------------------------------------------


@torch.no_grad()
def record_frame_plain(table, cam16, config: RenderConfig, frame: int = 0,
                       sample_base: int = 0, with_residuals: bool = True,
                       record_second: bool = False):
    """K2 in tensor ops, on any device: the same contract as `record_frame`.

    Vectorized over pixels in chunks that bound each [pixels, spheres]
    temporary; loops samples and bounces with alive masks, in the kernel's
    arithmetic order.  The sequential nearest-hit rule of the kernel becomes
    a first-index min over the valid roots, and its runner-up rule the
    first-index min over the valid roots farther than the winner."""
    if record_second and not with_residuals:
        raise ValueError("record_second requires with_residuals")
    geom, attr = _record_tables(table.detach())
    cam = cam16.detach()
    n = config.num_pixels
    dev = table.device
    spp, depth = config.samples_per_pixel, config.max_depth
    rdt = residual_dtype(table.shape[0])
    fb = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    res = (torch.empty((spp, depth, n), dtype=rdt, device=dev)
           if with_residuals else None)
    res2 = (torch.empty((spp, depth, n), dtype=rdt, device=dev)
            if record_second else None)
    budget = _PLAIN_WORKSPACE.get(dev.type, _PLAIN_WORKSPACE["cpu"])
    chunk = max(budget // geom.shape[0] // _LANES, 1) * _LANES
    seed = frame_seed(config, frame)
    pids = torch.arange(n, dtype=torch.int64, device=dev)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        out_res = None if res is None else res[:, :, lo:hi]
        out_res2 = None if res2 is None else res2[:, :, lo:hi]
        fb[lo:hi] = _plain_chunk(geom, attr, cam, pids[lo:hi], seed,
                                 sample_base, config, out_res, out_res2)
    img = (fb / spp).reshape(config.height, config.width, 3)
    return img, res, res2


def _plain_chunk(geom, attr, cam, pid, seed, sample_base, config, res, res2):
    where = torch.where
    spp, depth = config.samples_per_pixel, config.max_depth
    width, height = config.width, config.height
    t_min, t_max = config.t_min, config.t_max
    gx, gy, gz, kq = geom.T.contiguous().unbind(0)
    zero = torch.zeros(pid.shape, dtype=torch.float32, device=pid.device)
    fb_r, fb_g, fb_b = zero, zero, zero
    inf = torch.tensor(math.inf, device=pid.device)

    for s in range(spp):
        su = sample_base + s
        ox, oy, oz, dx, dy, dz = _plain_camera(cam, pid, su, seed, width,
                                               height)
        tp_r, tp_g, tp_b = zero + 1.0, zero + 1.0, zero + 1.0
        rad_r, rad_g, rad_b = zero, zero, zero
        alive = torch.ones_like(zero, dtype=torch.bool)

        for b in range(depth):
            # ---- per-sphere loop, expanded quadratic -------------------
            o_dot_d = ox * dx + oy * dy + oz * dz
            o2 = ox * ox + oy * oy + oz * oz
            c_dot_d = gx * dx[:, None] + gy * dy[:, None] + gz * dz[:, None]
            o_dot_c = ox[:, None] * gx + oy[:, None] * gy + oz[:, None] * gz
            half_b = o_dot_d[:, None] - c_dot_d
            cq = o2[:, None] - 2.0 * o_dot_c + kq
            disc = half_b * half_b - cq
            sq = torch.sqrt(disc)  # NaN on a miss: every compare fails
            rn = -half_b - sq
            tn = where(rn > t_min, rn, -half_b + sq)
            tn = where((tn > t_min) & (tn < t_max), tn, inf)
            bt, bidx = torch.min(tn, dim=1)
            hit = bt < inf
            if res is not None:
                res[s, b] = where(hit & alive, bidx, -1).to(res.dtype)
            if res2 is not None:
                bt2, bidx2 = torch.min(where(tn > bt[:, None], tn, inf), dim=1)
                res2[s, b] = where(hit & (bt2 < inf) & alive, bidx2,
                                   -1).to(res2.dtype)

            # ---- hit frame ---------------------------------------------
            bcx, bcy, bcz, _ = geom[bidx].unbind(1)
            binv, bar, bag, bab, bkd, bfz, bio, _ = attr[bidx].unbind(1)
            t_safe = where(hit, bt, 0.0)
            hx, hy, hz = ox + t_safe * dx, oy + t_safe * dy, oz + t_safe * dz
            nx = where(hit, (hx - bcx) * binv, 0.0)
            ny = where(hit, (hy - bcy) * binv, 0.0)
            nz = where(hit, (hz - bcz) * binv, 1.0)
            front = (dx * nx + dy * ny + dz * nz) < 0.0
            sgn = where(front, 1.0, -1.0)
            nx, ny, nz = nx * sgn, ny * sgn, nz * sgn

            # ---- shade -------------------------------------------------
            sx, sy, sz, is_die, scat_ok = _plain_scatter(
                dx, dy, dz, nx, ny, nz, front, bkd, bfz, bio,
                [_to_unit(v) for v in _pcg4d(pid, su, b, seed)])
            tsky = 0.5 * (dy + 1.0)
            add = alive & ~hit
            rad_r = rad_r + where(add, tp_r * (1.0 - 0.5 * tsky), 0.0)
            rad_g = rad_g + where(add, tp_g * (1.0 - 0.3 * tsky), 0.0)
            rad_b = rad_b + where(add, tp_b, 0.0)

            scat = alive & hit
            tp_r = where(scat, tp_r * where(is_die, 1.0, bar), tp_r)
            tp_g = where(scat, tp_g * where(is_die, 1.0, bag), tp_g)
            tp_b = where(scat, tp_b * where(is_die, 1.0, bab), tp_b)
            alive = scat & scat_ok
            ox, oy, oz = where(alive, hx, ox), where(alive, hy, oy), \
                where(alive, hz, oz)
            dx, dy, dz = where(alive, sx, dx), where(alive, sy, dy), \
                where(alive, sz, dz)
        fb_r, fb_g, fb_b = fb_r + rad_r, fb_g + rad_g, fb_b + rad_b
    return torch.stack([fb_r, fb_g, fb_b], dim=1)


# --- the wrapper ----------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _k2_launcher():
    lib = build.load("k2_record")
    fn = lib.brt_k2_record
    vp, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                         ctypes.c_float)
    fn.argtypes = [vp, vp, i32, vp, i32, vp, vp, vp, i32, i32, u32, u32, i32,
                   i32, f32, f32, i32, i32, vp]
    fn.restype = i32
    return fn


def _check_frame(table, cam16, config: RenderConfig, sample_base: int):
    device = table.device
    _check("table", table, torch.float32, (None, 11), device)
    _check("cam16", cam16, torch.float32, (16,), device)
    if not (0 <= sample_base < 2**32 and config.samples_per_pixel >= 1
            and config.max_depth >= 0 and 0 < config.num_pixels < 2**31):
        raise ValueError("sample_base must be 32-bit unsigned; spp >= 1, "
                         "max_depth >= 0, 0 < num_pixels < 2^31")


def record_frame(table, cam16, config: RenderConfig, frame: int = 0,
                 sample_base: int = 0, with_residuals: bool = True,
                 record_second: bool = False):
    """K2: render `config`'s frame from the sphere table and packed camera.

    table [S, 11] float32 is `sphere_table(...)` (its values only: no
    gradient flows through here); cam16 [16] float32 is `Camera.pack()`.
    Samples are [sample_base, sample_base + spp).  Returns (img [H, W, 3],
    res, res2): res [spp, max_depth, H*W] int16/int32 winner indices when
    `with_residuals` (else None), res2 the runner-ups when `record_second`
    (else None).

    CUDA tensors launch the kernel (and count one in
    `record_frame.launches`); CPU tensors run `record_frame_plain`; any other
    device raises."""
    if record_second and not with_residuals:
        raise ValueError("record_second requires with_residuals")
    table, cam16 = table.detach(), cam16.detach()
    _check_frame(table, cam16, config, sample_base)
    device = table.device
    if device.type == "cpu":
        return record_frame_plain(table, cam16, config, frame, sample_base,
                                  with_residuals, record_second)
    if device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA (or its twin on CPU), not {device}")
    geom, attr = _record_tables(table)
    n = config.num_pixels
    spp, depth = config.samples_per_pixel, config.max_depth
    rdt = residual_dtype(table.shape[0])
    img = torch.empty((n, 3), dtype=torch.float32, device=device)
    res = (torch.empty((spp, depth, n), dtype=rdt, device=device)
           if with_residuals else None)
    res2 = (torch.empty((spp, depth, n), dtype=rdt, device=device)
            if record_second else None)
    launch = _k2_launcher()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(geom.data_ptr(), attr.data_ptr(), geom.shape[0],
                     cam16.data_ptr(), n, img.data_ptr(),
                     0 if res is None else res.data_ptr(),
                     0 if res2 is None else res2.data_ptr(),
                     2 if rdt == torch.int16 else 4,
                     int(with_residuals) + int(record_second),
                     frame_seed(config, frame), sample_base, spp, depth,
                     config.t_min, config.t_max, config.width, config.height,
                     stream)
    if err != 0:
        raise RuntimeError(f"K2 launch failed with cudaError_t {err}")
    record_frame.launches += 1
    return img.reshape(config.height, config.width, 3), res, res2


record_frame.launches = 0


# --- host side ----------------------------------------------------------


def _reject_unported(clusters, pixel_base, num_local):
    for name, value in (("clusters", clusters), ("pixel_base", pixel_base),
                        ("num_local", num_local)):
        if value is not None:
            raise NotImplementedError(
                f"{name}= is not ported yet (ROADMAP.md: the cluster broad "
                f"phase of K2 and the stripe modes of K2/K3 come later)")


def _operands(scene, camera):
    table = sphere_table(scene.centers, scene.radii, scene.materials,
                         scene.material_id)
    return table.detach().contiguous(), camera.pack().detach().contiguous()


def render_record(scene, camera, config: RenderConfig, frame: int = 0,
                  sample_base: int = 0, record_second: bool = False,
                  clusters=None, pixel_base=None, num_local=None):
    """Recording forward render on K2 -> (img [H, W, 3], res, res2 or None).

    The port of `render_pallas(..., with_residuals=True, record_second=...)`.
    res/res2 are [spp, max_depth, H*W] sphere indices (int16 when the
    scene has at most 32,767 spheres, else int32; -1 = no hit)."""
    _reject_unported(clusters, pixel_base, num_local)
    table, cam16 = _operands(scene, camera)
    return record_frame(table, cam16, config, frame, sample_base, True,
                        record_second)


def render_record_plain(scene, camera, config: RenderConfig, frame: int = 0,
                        sample_base: int = 0, record_second: bool = False,
                        clusters=None, pixel_base=None, num_local=None):
    """`render_record` through K2's plain twin, on any device."""
    _reject_unported(clusters, pixel_base, num_local)
    table, cam16 = _operands(scene, camera)
    return record_frame_plain(table, cam16, config, frame, sample_base, True,
                              record_second)

