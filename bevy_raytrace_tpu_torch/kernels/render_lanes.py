"""K1, the main-path kernel: its wrapper, its plain PyTorch twin, its host side.

`render_lanes` is the wrapper of the CUDA kernel `csrc/k1_render.cu`, which
replaces `bevy_raytrace_tpu/kernels/mxu_render.py::_make_kernel` (the TPU's
v3 whole-frame forward kernel).  On CUDA tensors it launches the kernel or
raises; on CPU tensors it runs `render_lanes_plain`, the twin in this module
that computes the same thing with tensor ops.  The kernel is bound by fp32
issue in the sphere sweep and by warp divergence, not by bytes;
`balance_perm` exists to put pixels of similar path length into one warp.

Host side, by the reference's names (bevy_raytrace_tpu/kernels/mxu_render.py):
  render_mxu_lanes, render_mxu_with_len, render_mxu, lane_pad,
  _morton_rank, balance_perm, render_mxu_balanced  -> same names here;
  _scene_matrices -> `_scene_tables` (plain float32 sphere tables, no bf16
  limbs); the probe -> balance_perm -> rest sequence of render_mxu_balanced
  and of the engine's session path -> `render_probed`.

Deliberate divergences from the reference:
  * no 1,024-sphere cap: the nearest hit is a (t, index) pair, not a 10-bit
    packed key, and ties go to the lowest index on the exact t;
  * no 2^24 limit on lanes or samples (counters are integers, not f32);
  * the TPU tiling options (tile_rows, v_planes, sphere_chunk, plan culling,
    round_unroll, debug probes) and `track_len` do not exist: the path-length
    count costs one register add per round, so it is always kept;
  * lanes are padded to a multiple of 128, not to 1,024-lane tiles.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from bevy_raytrace_tpu_torch.config import RenderConfig
from bevy_raytrace_tpu_torch.kernels import build
from bevy_raytrace_tpu_torch.kernels.common import (
    _pcg4d,
    _plain_camera,
    _plain_scatter,
    _to_unit,
)
from bevy_raytrace_tpu_torch.wavefront.render import frame_seed

LANE_ALIGN = 128
# Float elements of one [lanes, spheres] temporary in the twin's sweep: the
# twin steps through the lanes in chunks that keep each temporary this size.
_PLAIN_WORKSPACE = {"cpu": 1 << 22, "cuda": 1 << 26}
# Path-length quantum of balance_perm's sort key (steps of 1/2 round).
_QUANT = 2.0


def _scene_tables(scene):
    """Scene -> (geom [S,4], attr [S,8]) float32, on the scene's device.

    geom row: (cx, cy, cz, r^2).  attr row: (1/r, albedo r, g, b, kind,
    fuzz, ior, 0); 1/r keeps the radius sign (hollow glass).  An empty scene
    gets one row that no ray can hit (r^2 = -1)."""
    c, r = scene.centers, scene.radii
    if scene.count == 0:
        geom = c.new_tensor([[0.0, 0.0, 0.0, -1.0]])
        return geom, c.new_tensor([[1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0]])
    mid = scene.material_id.long()
    m = scene.materials
    geom = torch.stack([c[:, 0], c[:, 1], c[:, 2], r * r], dim=1)
    attr = torch.stack([
        1.0 / r, m.albedo[mid, 0], m.albedo[mid, 1], m.albedo[mid, 2],
        m.kind[mid].to(torch.float32), m.fuzz[mid], m.ior[mid],
        torch.zeros_like(r),
    ], dim=1)
    return geom.contiguous(), attr.contiguous()


# --- the plain twin -----------------------------------------------------


@torch.no_grad()
def render_lanes_plain(geom, attr, cam, pids, seed: int, sample_base: int,
                       spp: int, max_depth: int, t_min: float, width: int,
                       height: int):
    """K1 in tensor ops, on any device: same inputs and outputs as
    `render_lanes`.  Vectorized over lanes, in chunks that bound the
    [lanes, spheres] workspace; loops samples and bounces with alive masks,
    with the kernel's arithmetic in the kernel's order."""
    n = pids.shape[0]
    fb = torch.zeros((n, 3), dtype=torch.float32, device=pids.device)
    ln = torch.zeros((n,), dtype=torch.float32, device=pids.device)
    budget = _PLAIN_WORKSPACE.get(pids.device.type, _PLAIN_WORKSPACE["cpu"])
    chunk = max(budget // geom.shape[0] // LANE_ALIGN, 1) * LANE_ALIGN
    for lo in range(0, n, chunk):
        fb[lo:lo + chunk], ln[lo:lo + chunk] = _plain_chunk(
            geom, attr, cam, pids[lo:lo + chunk].to(torch.int64), seed,
            sample_base, spp, max_depth, t_min, width, height)
    return fb, ln


def _plain_chunk(geom, attr, cam, pid, seed, sample_base, spp, max_depth,
                 t_min, width, height):
    where = torch.where
    gx, gy, gz, gr2 = geom.T.contiguous().unbind(0)
    zero = torch.zeros(pid.shape, dtype=torch.float32, device=pid.device)
    acc_r, acc_g, acc_b, rounds = zero, zero, zero, zero

    for s in range(spp):
        su = sample_base + s
        # ---- camera ray (thin lens) ------------------------------------
        ox, oy, oz, dx, dy, dz = _plain_camera(cam, pid, su, seed, width,
                                               height)
        tp_r, tp_g, tp_b = zero + 1.0, zero + 1.0, zero + 1.0
        alive = torch.ones_like(zero, dtype=torch.bool)

        for bounce in range(max_depth):
            if bounce and not bool(alive.any()):
                break
            rounds = rounds + alive.to(torch.float32)
            # ---- dense sweep: nearest hit, first index wins ties -------
            ocx = ox[:, None] - gx
            ocy = oy[:, None] - gy
            ocz = oz[:, None] - gz
            hb = ocx * dx[:, None] + ocy * dy[:, None] + ocz * dz[:, None]
            cq = (ocx * ocx + ocy * ocy + ocz * ocz) - gr2
            disc = hb * hb - cq
            sq = disc * torch.rsqrt(disc)  # NaN (a miss) for disc <= 0
            rn = -hb - sq
            tn = where(rn > t_min, rn, sq - hb)
            tn = where(tn > t_min, tn, math.inf)
            best_t, best = torch.min(tn, dim=1)
            hit = best_t < math.inf

            # ---- exact t of the winner, hit frame ----------------------
            bcx, bcy, bcz, br2 = geom[best].unbind(1)
            binv, bar, bag, bab, bkd, bfz, bio, _ = attr[best].unbind(1)
            rocx, rocy, rocz = ox - bcx, oy - bcy, oz - bcz
            hb_r = rocx * dx + rocy * dy + rocz * dz
            cq_r = (rocx * rocx + rocy * rocy + rocz * rocz) - br2
            sq_r = torch.sqrt(torch.clamp(hb_r * hb_r - cq_r, min=0.0))
            rn_r = -hb_r - sq_r
            bt = where(rn_r > t_min, rn_r, sq_r - hb_r)
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
                [_to_unit(v) for v in _pcg4d(pid, su, bounce, seed)])

            tsky = 0.5 * (dy + 1.0)
            add = alive & ~hit
            acc_r = acc_r + where(add, tp_r * (1.0 - 0.5 * tsky), 0.0)
            acc_g = acc_g + where(add, tp_g * (1.0 - 0.3 * tsky), 0.0)
            acc_b = acc_b + where(add, tp_b, 0.0)

            scat = alive & hit
            tp_r = where(scat, tp_r * where(is_die, 1.0, bar), tp_r)
            tp_g = where(scat, tp_g * where(is_die, 1.0, bag), tp_g)
            tp_b = where(scat, tp_b * where(is_die, 1.0, bab), tp_b)
            # Depth exhaustion kills the path with black.
            alive = scat & scat_ok & (bounce + 1 < max_depth)
            ox, oy, oz = where(alive, hx, ox), where(alive, hy, oy), \
                where(alive, hz, oz)
            dx, dy, dz = where(alive, sx, dx), where(alive, sy, dy), \
                where(alive, sz, dz)
    return torch.stack([acc_r, acc_g, acc_b], dim=1), rounds


# --- the wrapper ----------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _k1_launcher():
    lib = build.load("k1_render")
    fn = lib.brt_k1_render
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, i32, vp, vp, i32, vp, vp, ctypes.c_uint,
                   ctypes.c_uint, i32, i32, ctypes.c_float, i32, i32, vp]
    fn.restype = i32
    return fn


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the operands on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if any(want is not None and got != want
           for got, want in zip(t.shape, shape)) or t.dim() != len(shape):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def render_lanes(geom, attr, cam, pids, seed: int, sample_base: int, spp: int,
                 max_depth: int, t_min: float, width: int, height: int):
    """K1: render the absolute pixel ids `pids` [n] int32, one per lane.

    geom [S,4] and attr [S,8] float32 are `_scene_tables(scene)`; cam [16]
    float32 is `Camera.pack()`; seed is the frame's 32-bit seed counter;
    samples are [sample_base, sample_base + spp).  Returns (fb [n,3],
    len [n]): per-lane radiance and executed-round sums over the samples
    (not yet divided by spp).  n must be a multiple of 128.

    CUDA tensors launch the kernel (and count one in `render_lanes.launches`);
    CPU tensors run `render_lanes_plain`; any other device raises."""
    device = pids.device
    _check("pids", pids, torch.int32, (None,), device)
    n_spheres = geom.shape[0] if isinstance(geom, torch.Tensor) else 0
    _check("geom", geom, torch.float32, (n_spheres, 4), device)
    _check("attr", attr, torch.float32, (n_spheres, 8), device)
    _check("cam", cam, torch.float32, (16,), device)
    n = pids.shape[0]
    if n % LANE_ALIGN or n_spheres == 0:
        raise ValueError(f"need a multiple of {LANE_ALIGN} lanes (got {n}) "
                         f"and at least one sphere row (got {n_spheres})")
    if not (0 <= seed < 2**32 and 0 <= sample_base < 2**32 and spp >= 0
            and max_depth >= 0 and width > 0 and height > 0):
        raise ValueError("seed/sample_base must be 32-bit unsigned; spp, "
                         "max_depth >= 0; width, height > 0")
    if device.type == "cpu":
        return render_lanes_plain(geom, attr, cam, pids, seed, sample_base,
                                  spp, max_depth, t_min, width, height)
    if device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA (or its twin on CPU), not {device}")
    fb = torch.empty((n, 3), dtype=torch.float32, device=device)
    ln = torch.empty((n,), dtype=torch.float32, device=device)
    launch = _k1_launcher()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(geom.data_ptr(), attr.data_ptr(), n_spheres,
                     cam.data_ptr(), pids.data_ptr(), n, fb.data_ptr(),
                     ln.data_ptr(), seed, sample_base, spp, max_depth,
                     t_min, width, height, stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed with cudaError_t {err}")
    render_lanes.launches += 1
    return fb, ln


render_lanes.launches = 0


# --- host side ----------------------------------------------------------


def render_mxu_lanes(scene, camera, config: RenderConfig, pid_grid, frame=0,
                     sample_base: int = 0):
    """Raw lane-slot render: `pid_grid` int32 [rows, 128] holds the
    ABSOLUTE pixel id of each lane.  Returns (fb [p, 3], len [p]) in
    lane-slot order, divided by spp."""
    geom, attr = _scene_tables(scene)
    fb, ln = render_lanes(
        geom, attr, camera.pack().contiguous(), pid_grid.reshape(-1),
        frame_seed(config, frame), sample_base, config.samples_per_pixel,
        config.max_depth, config.t_min, config.width, config.height)
    inv_spp = float(np.float32(1.0 / config.samples_per_pixel))
    return fb * inv_spp, ln * inv_spp


def lane_pad(num_pixels: int) -> int:
    """Lane-slot count for `num_pixels` (a multiple of 128)."""
    return -(-num_pixels // LANE_ALIGN) * LANE_ALIGN


def render_mxu_with_len(scene, camera, config: RenderConfig, frame=0,
                        perm=None, sample_base: int = 0):
    """Forward render on K1 -> (image [H, W, 3], mean path length [H, W]).

    `perm`: optional int32 [num_pixels] permutation of absolute pixel ids
    (from `balance_perm`); lane i renders perm[i] and the result is
    scattered back, so the image is bit-identical for any perm."""
    n = config.num_pixels
    dev = scene.device
    if config.max_depth <= 0:
        return (torch.zeros((config.height, config.width, 3), device=dev),
                torch.zeros((config.height, config.width), device=dev))
    # Padding lanes render ids past the image; they are dropped below.
    tail = torch.arange(0 if perm is None else n, lane_pad(n),
                        dtype=torch.int32, device=dev)
    if perm is None:
        pids = tail
    elif tuple(perm.shape) != (n,):
        raise ValueError(f"perm must have shape ({n},), got "
                         f"{tuple(perm.shape)}")
    else:
        pids = torch.cat([perm.to(device=dev, dtype=torch.int32), tail])
    fb, ln = render_mxu_lanes(scene, camera, config,
                              pids.reshape(-1, LANE_ALIGN), frame, sample_base)
    idx = pids[:n].long()
    img = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    img[idx] = fb[:n]
    lmap = torch.zeros((n,), dtype=torch.float32, device=dev)
    lmap[idx] = ln[:n]
    return (img.reshape(config.height, config.width, 3),
            lmap.reshape(config.height, config.width))


def render_mxu(scene, camera, config: RenderConfig, frame=0, perm=None):
    """Forward render on K1 -> linear float32 [H, W, 3]."""
    return render_mxu_with_len(scene, camera, config, frame, perm=perm)[0]


@functools.lru_cache(maxsize=8)
def _morton_rank(height: int, width: int):
    """Raster pid -> rank along the Morton (Z-order) curve of (x, y); the
    secondary sort key, so equal-cost pixels stay spatially compact."""
    y, x = np.mgrid[0:height, 0:width].astype(np.uint64)

    def part(v):
        v = (v | (v << 16)) & np.uint64(0x0000FFFF0000FFFF)
        v = (v | (v << 8)) & np.uint64(0x00FF00FF00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x3333333333333333)
        v = (v | (v << 1)) & np.uint64(0x5555555555555555)
        return v

    code = (part(x) | (part(y) << np.uint64(1))).reshape(-1)
    rank = np.empty(code.size, np.int32)
    rank[np.argsort(code, kind="stable")] = np.arange(code.size, dtype=np.int32)
    return rank


def balance_perm(len_map):
    """Pixel permutation sorting by measured path length [H, W].

    Pixels of one warp then share a similar per-sample cost, so few lanes
    idle while the slowest finishes.  The cost is quantized to 1/2 round
    and ties break along the Morton curve, so warps stay spatially compact."""
    h, w = len_map.shape
    rank = torch.from_numpy(_morton_rank(h, w)).to(len_map.device,
                                                   torch.int64)
    key = torch.round(len_map.reshape(-1) * _QUANT).to(torch.int64) * (h * w)
    return torch.argsort(key + rank).to(torch.int32)


def render_probed(scene, camera, config: RenderConfig, frame=0,
                  probe_spp: int = 16):
    """Probe -> balance_perm -> the rest of the samples on the perm.

    The probe renders samples [0, probe_spp) in identity layout and its
    samples count; the balanced pass renders [probe_spp, spp).  Every path
    is the plain render's; only the per-pixel summation is split in two.
    Returns (image [H, W, 3], perm)."""
    spp = config.samples_per_pixel
    probe_spp = min(probe_spp, spp)
    probe_img, len_map = render_mxu_with_len(
        scene, camera, config.replace(samples_per_pixel=probe_spp,
                                      spp_chunk=0), frame)
    perm = balance_perm(len_map)
    rest = spp - probe_spp
    if rest == 0:
        return probe_img, perm
    rest_img, _ = render_mxu_with_len(
        scene, camera, config.replace(samples_per_pixel=rest, spp_chunk=0),
        frame, perm=perm, sample_base=probe_spp)
    w = np.float32(1.0 / spp)
    return (probe_img * float(w * np.float32(probe_spp))
            + rest_img * float(w * np.float32(rest))), perm


def render_mxu_balanced(scene, camera, config: RenderConfig, frame=0,
                        probe_spp: int = 16):
    """Cost-balanced forward render (probe, then the rest on the sorted
    perm) -> linear float32 [H, W, 3]."""
    return render_probed(scene, camera, config, frame, probe_spp)[0]
