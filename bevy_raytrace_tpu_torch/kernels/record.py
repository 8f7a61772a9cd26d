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

Stripe mode (`pixel_base`, `num_local`, as `pallas_render.py:601-656`): the
launch renders the `num_local` pixels from absolute id `pixel_base`; RNG
counters and pixel coordinates come from the absolute id, the image is the
flat [num_local, 3] stripe and the residuals are [spp, max_depth,
num_local].  Stripes compose bit for bit into the full frame.

Cluster-culled traversal (`clusters=`, a `kernels.clusters.ClusterPlan`; as
`pallas_render.py:324-398`): the host gathers the sphere rows into the
plan's Morton order and computes the clusters' bounding spheres from the
live table on its device (`cluster_bounds`), and the kernel walks only the
members of the clusters a ray's bound test hits.  Image and paths are those
of the brute-force loop except where two different spheres tie exactly
(the members are visited in Morton order).  The plain twin with `clusters=`
is the brute-force loop over the members in Morton order, WITHOUT the bound
test: it shares no arithmetic with the cull, so a kernel-vs-twin difference
on the card exposes a bound that is not conservative instead of repeating
it.  Deliberate divergences from the reference: residuals are SCENE indices
with or without a plan (the TPU kernel records indices into its permuted
table and hands the permutation to the replay), so the replay needs no
plan and int16 depends on the scene's count only; any `cluster_size` >= 1
is taken (the TPU kernel needs a multiple of its unroll); pad slots are not
visited.  The TPU tiling options (tile_rows, unroll, skip_dead_tiles) do
not exist here.

The plan picks the kernel, and with it the schedule.  Without one,
`k2_record_kernel` runs the nested loop (a thread a pixel, for each sample
for each bounce, every sphere): on a handful of spheres it beats a round
loop (K4's took ~3x as long on config1's 3 spheres, PERF.md) and there is no
cull to share.  With one, `k2_record_kernel_culled` runs culled K1's
schedule: per-lane refill rounds (a path that ends stores -1 into its later
bounces and the thread starts its next sample) and the warp's (cluster,
lane) pair queue, which sweeps each lane's own live clusters, not the union
of its warp's; the winner and runner-up of the clusters are merged by
atomicMin on (t, row) keys, which gives the sequential loop's bits (the
kernel's header has the argument).  Both kernels add each pixel's samples in
order, so the image does not depend on the schedule.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from bevy_raytrace_tpu_torch.config import RenderConfig
from bevy_raytrace_tpu_torch.core.geometry import sphere_table
from bevy_raytrace_tpu_torch.kernels import build
from bevy_raytrace_tpu_torch.kernels.clusters import (
    check_plan,
    cluster_bounds,
)
from bevy_raytrace_tpu_torch.kernels.common import (
    _pcg4d,
    _plain_camera,
    _plain_scatter,
    _to_unit,
)
from bevy_raytrace_tpu_torch.kernels.render_lanes import _check
from bevy_raytrace_tpu_torch.utils.spans import count
from bevy_raytrace_tpu_torch.wavefront.render import frame_seed

# Residuals are int16 up to this many sphere slots, int32 above.
INT16_SLOTS = 32767
# Float elements of one [lanes, spheres] temporary in the twin's sweep.
_PLAIN_WORKSPACE = {"cpu": 1 << 22, "cuda": 1 << 26}
_LANES = 128


def residual_dtype(n_spheres: int) -> torch.dtype:
    """The residual dtype for a scene of `n_spheres`."""
    return torch.int16 if n_spheres <= INT16_SLOTS else torch.int32


def _stripe(config: RenderConfig, pixel_base, num_local):
    """(first absolute pixel id, pixel count) of a launch: the whole frame
    when `num_local` is None, else the stripe [pixel_base, pixel_base +
    num_local), which must lie inside the frame."""
    if num_local is None:
        if pixel_base is not None:
            raise ValueError("pixel_base needs num_local (stripe mode takes "
                             "both)")
        return 0, config.num_pixels
    base = 0 if pixel_base is None else int(pixel_base)
    n = int(num_local)
    if n < 1 or base < 0 or base + n > config.num_pixels:
        raise ValueError(
            f"stripe [{base}, {base + n}) must be non-empty and inside the "
            f"frame's {config.num_pixels} pixels")
    return base, n


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


def _members(table, clusters):
    """The plan's real members in Morton order: int64 [S] scene indices on
    the table's device (the plan's permutation without its pad slots)."""
    check_plan(clusters, table.shape[0])
    return clusters.on(table.device)[0][:table.shape[0]]


def _scene_indices(res, members):
    """Residuals that index the Morton-ordered rows -> scene indices."""
    if res is None:
        return None
    return torch.where(res >= 0, members[res.long().clamp(min=0)],
                       -1).to(res.dtype)


# --- the plain twin -----------------------------------------------------


@torch.no_grad()
def record_frame_plain(table, cam16, config: RenderConfig, frame: int = 0,
                       sample_base: int = 0, with_residuals: bool = True,
                       record_second: bool = False, pixel_base=None,
                       num_local=None, clusters=None, live=None):
    """K2 in tensor ops, on any device: the same contract as `record_frame`.

    Vectorized over pixels in chunks that bound each [pixels, spheres]
    temporary; loops samples and bounces with alive masks, in the kernel's
    arithmetic order.  The sequential nearest-hit rule of the kernel becomes
    a first-index min over the valid roots, and its runner-up rule the
    first-index min over the valid roots farther than the winner.

    With `clusters` the spheres are swept in the plan's Morton order (first
    member wins a tie) with no bound test, and the recorded indices are
    mapped back to scene indices.  `live` (with `clusters`) is filled as
    the kernel fills it, from the kernel's bound test in tensor ops (each
    operation rounded, no fma) run on the twin's own paths: it only counts,
    and decides nothing."""
    if record_second and not with_residuals:
        raise ValueError("record_second requires with_residuals")
    table = table.detach()
    if live is not None:
        _check_live(live, table, clusters, config, pixel_base, num_local)
    if clusters is not None:
        members = _members(table, clusters)
        bounds = None if live is None else _bounds(table, clusters)
        img, res, res2 = _record_plain(
            table[members], cam16, config, frame, sample_base,
            with_residuals, record_second, pixel_base, num_local, bounds,
            live)
        return (img, _scene_indices(res, members),
                _scene_indices(res2, members))
    return _record_plain(table, cam16, config, frame, sample_base,
                         with_residuals, record_second, pixel_base, num_local)


def _check_live(live, table, clusters, config, pixel_base, num_local):
    """Refuse a `live` buffer the launch cannot fill."""
    if clusters is None:
        raise ValueError("live counts the culled traversal's pairs: it "
                         "needs clusters")
    _check("live", live, torch.int32,
           (2, _stripe(config, pixel_base, num_local)[1]), table.device)


def _bounds(table, clusters):
    """The clusters' bounds [C, 4] (bx, by, bz, |b|^2 - br^2), from the live
    table on its device."""
    return torch.stack(cluster_bounds(table[:, :3], table[:, 3], clusters),
                       dim=1).contiguous()


def _record_plain(table, cam16, config, frame, sample_base, with_residuals,
                  record_second, pixel_base, num_local, bounds=None,
                  live=None):
    """`record_frame_plain` on rows in their sweep order; with `bounds`
    [C, 4] it also fills `live` [2, npix] (the pairs and rounds of the
    culled kernel's bound tests, clusters of consecutive rows)."""
    geom, attr = _record_tables(table)
    cam = cam16.detach()
    base, n = _stripe(config, pixel_base, num_local)
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
    pids = torch.arange(base, base + n, dtype=torch.int64, device=dev)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        out_res = None if res is None else res[:, :, lo:hi]
        out_res2 = None if res2 is None else res2[:, :, lo:hi]
        out_live = None if live is None else live[:, lo:hi]
        fb[lo:hi] = _plain_chunk(geom, attr, cam, pids[lo:hi], seed,
                                 sample_base, config, out_res, out_res2,
                                 bounds, out_live)
    img = fb / spp
    if num_local is None:
        img = img.reshape(config.height, config.width, 3)
    return img, res, res2


def _plain_chunk(geom, attr, cam, pid, seed, sample_base, config, res, res2,
                 bounds=None, live=None):
    where = torch.where
    spp, depth = config.samples_per_pixel, config.max_depth
    width, height = config.width, config.height
    t_min, t_max = config.t_min, config.t_max
    gx, gy, gz, kq = geom.T.contiguous().unbind(0)
    zero = torch.zeros(pid.shape, dtype=torch.float32, device=pid.device)
    fb_r, fb_g, fb_b = zero, zero, zero
    inf = torch.tensor(math.inf, device=pid.device)
    if live is not None:
        live.zero_()

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
            if live is not None:
                live[0] += _live_clusters(bounds, alive, ox, oy, oz, dx, dy,
                                          dz, o_dot_d, o2, t_min)
                live[1] += alive.to(live.dtype)
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


def _live_clusters(bounds, alive, ox, oy, oz, dx, dy, dz, o_dot_d, o2,
                   t_min):
    """Each alive lane's count of live clusters by the culled kernel's bound
    test (the far root of the expanded quadratic against the cluster's
    bounding sphere > t_min) -> int32 [lanes]."""
    bx, by, bz, bkq = bounds.T.contiguous().unbind(0)
    c_dot_d = bx * dx[:, None] + by * dy[:, None] + bz * dz[:, None]
    o_dot_c = ox[:, None] * bx + oy[:, None] * by + oz[:, None] * bz
    hb = o_dot_d[:, None] - c_dot_d
    cq = o2[:, None] - 2.0 * o_dot_c + bkq
    rfar = torch.sqrt(hb * hb - cq) - hb
    return ((rfar > t_min) & alive[:, None]).sum(1, dtype=torch.int32)


# --- the wrapper ----------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _k2_launcher():
    lib = build.load("k2_record")
    fn = lib.brt_k2_record
    vp, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                         ctypes.c_float)
    fn.argtypes = [vp, vp, i32, vp, vp, i32, i32, vp, i32, i32, vp, vp, vp,
                   i32, i32, u32, u32, i32, i32, f32, f32, i32, i32, vp, vp]
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
                 record_second: bool = False, pixel_base=None,
                 num_local=None, clusters=None, live=None):
    """K2: render `config`'s frame, or one stripe of it, from the sphere
    table and packed camera.

    table [S, 11] float32 is `sphere_table(...)` (its values only: no
    gradient flows through here); cam16 [16] float32 is `Camera.pack()`.
    Samples are [sample_base, sample_base + spp).  With `num_local` the
    pixels are [pixel_base, pixel_base + num_local) and the image is the
    flat [num_local, 3] stripe; else the whole frame, [H, W, 3].  Returns
    (img, res, res2): res [spp, max_depth, npix] int16/int32 winner indices
    when `with_residuals` (else None), res2 the runner-ups when
    `record_second` (else None).  `clusters` (a `ClusterPlan` of this
    scene's sphere count) selects the cluster-culled loop; the residuals
    are scene indices either way.  `live` (with `clusters`; None on the
    main path) is an int32 [2, npix] buffer on the table's device: the
    culled launch writes each pixel's queued (cluster, pixel) pairs, its
    live clusters summed over its rounds, into live[0] and its rounds into
    live[1], and adds their sums to the counters `k2.pairs` and
    `k2.lane_rounds`, which waits for the launch.

    CUDA tensors launch the kernel (and count one in the counter
    `k2.launches`, and in `k2.launches_clustered` when culled); CPU
    tensors run `record_frame_plain`; any other device raises."""
    if record_second and not with_residuals:
        raise ValueError("record_second requires with_residuals")
    table, cam16 = table.detach(), cam16.detach()
    _check_frame(table, cam16, config, sample_base)
    base, n = _stripe(config, pixel_base, num_local)
    device = table.device
    if device.type == "cpu":
        return record_frame_plain(table, cam16, config, frame, sample_base,
                                  with_residuals, record_second, pixel_base,
                                  num_local, clusters, live)
    if device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA (or its twin on CPU), not {device}")
    if live is not None:
        _check_live(live, table, clusters, config, pixel_base, num_local)
    bounds = members = None
    if clusters is not None:
        # Bounds from the live table; rows gathered into Morton order so
        # that a cluster's members are contiguous float4 loads.
        order = _members(table, clusters)  # checks the plan
        bounds = _bounds(table, clusters)
        members = order.to(torch.int32)
        table = table[order]
    geom, attr = _record_tables(table)
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
                     0 if bounds is None else bounds.data_ptr(),
                     0 if members is None else members.data_ptr(),
                     0 if clusters is None else clusters.n_clusters,
                     0 if clusters is None else clusters.cluster_size,
                     cam16.data_ptr(), base, n, img.data_ptr(),
                     0 if res is None else res.data_ptr(),
                     0 if res2 is None else res2.data_ptr(),
                     2 if rdt == torch.int16 else 4,
                     int(with_residuals) + int(record_second),
                     frame_seed(config, frame), sample_base, spp, depth,
                     config.t_min, config.t_max, config.width, config.height,
                     0 if live is None else live.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K2 launch failed with cudaError_t {err}")
    count("k2.launches")
    if clusters is not None:
        count("k2.launches_clustered")
    if live is not None:
        count("k2.pairs", int(live[0].sum()))
        count("k2.lane_rounds", int(live[1].sum()))
    if num_local is None:
        img = img.reshape(config.height, config.width, 3)
    return img, res, res2


# --- host side ----------------------------------------------------------


def _operands(scene, camera):
    table = sphere_table(scene.centers, scene.radii, scene.materials,
                         scene.material_id)
    return table.detach().contiguous(), camera.pack().detach().contiguous()


def render_record(scene, camera, config: RenderConfig, frame: int = 0,
                  sample_base: int = 0, record_second: bool = False,
                  clusters=None, pixel_base=None, num_local=None):
    """Recording forward render on K2 -> (img, res, res2 or None).

    The port of `render_pallas(..., with_residuals=True, record_second=...)`.
    img is [H, W, 3], or the flat [num_local, 3] stripe in stripe mode;
    res/res2 are [spp, max_depth, npix] scene sphere indices (int16 when the
    scene has at most 32,767 spheres, else int32; -1 = no hit).  `clusters`:
    a `ClusterPlan` for the culled traversal."""
    table, cam16 = _operands(scene, camera)
    return record_frame(table, cam16, config, frame, sample_base, True,
                        record_second, pixel_base, num_local, clusters)


def render_record_plain(scene, camera, config: RenderConfig, frame: int = 0,
                        sample_base: int = 0, record_second: bool = False,
                        clusters=None, pixel_base=None, num_local=None):
    """`render_record` through K2's plain twin, on any device."""
    table, cam16 = _operands(scene, camera)
    return record_frame_plain(table, cam16, config, frame, sample_base, True,
                              record_second, pixel_base, num_local, clusters)


def render_pallas(scene, camera, config: RenderConfig, frame: int = 0,
                  clusters=None, with_residuals: bool = False,
                  record_second: bool = False, sample_base: int = 0,
                  pixel_base=None, num_local=None):
    """The forward render on K2: the port of `render_pallas`
    (`pallas_render.py:588`), the `pallas` backend.

    Returns the image [H, W, 3] (the flat [num_local, 3] stripe in stripe
    mode); with `with_residuals` (img, res), with `record_second` too (img,
    res, res2), as the reference does.  `clusters`: a `ClusterPlan` for the
    culled traversal, None for the brute-force loop.  On a CUDA scene it
    launches K2, on a CPU scene it runs K2's plain twin."""
    table, cam16 = _operands(scene, camera)
    img, res, res2 = record_frame(table, cam16, config, frame, sample_base,
                                  with_residuals, record_second, pixel_base,
                                  num_local, clusters)
    if not with_residuals:
        return img
    return (img, res, res2) if record_second else (img, res)
