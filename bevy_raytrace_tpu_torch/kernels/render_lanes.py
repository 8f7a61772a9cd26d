"""K1, the main-path kernel: its wrapper, its plain PyTorch twin, its host side.

`render_lanes` is the wrapper of the CUDA kernel `csrc/k1_render.cu`, which
replaces `bevy_raytrace_tpu/kernels/mxu_render.py::_make_kernel` (the TPU's
v3 whole-frame forward kernel).  On CUDA tensors it launches the kernel or
raises; on CPU tensors it runs `render_lanes_plain`, the twin in this module
that computes the same thing with tensor ops.  The kernel is bound by fp32
issue in the sphere sweep, not by bytes.  Each lane refills itself with its
pixel's next sample when a path ends (one loop over rounds), so a lane
idles only once its own samples are done; `balance_perm` puts pixels of
similar path length into one warp so that they finish together.

Table modes (`kernels/common.py::forward_table_plan`, by the sphere count):
the kernel stages the sphere rows in shared memory once a block
("shared") unless that would leave too few blocks resident on an SM; then
it reads them through the read-only cache ("global").  Both give the same
bits; the global launches are counted apart (the counter
`k1.launches_global`).

The chunk-culled traversal (`plan=`, a `kernels.clusters.ClusterPlan`; the
TPU kernel with `n_cull > 0`, `mxu_render.py:364-467`): the rows are
gathered into the plan's Morton order, and each round a lane takes an upper
bound t_ub on its nearest hit from the plan's priority spheres and its own
previous winner, tests its ray against every chunk's bounding sphere, and
sweeps the members of the chunks that may hold a hit before t_ub only.  The
bound test is conservative against the member test's own rounding (a slack
of `CULL_SLACK` u times the ray's squared distance to the bound, derived at
the kernel's `chunk_live`) and a tie goes to the lower SCENE index, so the
image and the cost map equal the dense sweep's bit for bit.  Culled launches
are counted apart too (`k1.launches_culled`); on the card a culled call
launches the culled kernel or raises, never the dense one.

Host side, by the reference's names (bevy_raytrace_tpu/kernels/mxu_render.py):
  render_mxu_lanes, render_mxu_with_len, render_mxu, lane_pad,
  _morton_rank, balance_perm, render_mxu_balanced  -> same names here;
  _scene_matrices -> `_scene_tables` (plain float32 sphere tables, no bf16
  limbs; with a plan also the chunk bounds, members and priority rows); the
  probe -> balance_perm -> rest sequence of render_mxu_balanced and of the
  engine's session path -> `render_probed`.

Deliberate divergences from the reference:
  * no 1,024-sphere cap: the nearest hit is a (t, index) pair, not a 10-bit
    packed key, and ties go to the lowest index on the exact t;
  * the culled traversal breaks a tie on the scene index, not on the slot in
    the plan's order (the reference's packed key), so culled equals dense
    even where two spheres of different chunks tie exactly; its chunk
    bounds store br^2 squared directly (`clusters.sphere_bounds`), and pad
    slots are skipped rather than swept as duplicates;
  * the culled bound test carries a slack for the member test's rounding
    (`CULL_SLACK`), which the reference's has not, so culled equals dense
    at every cluster size, 1 included;
  * no 2^24 limit on lanes or samples (counters are integers, not f32);
  * the TPU tiling options (tile_rows, v_planes, sphere_chunk, round_unroll,
    debug probes) and `track_len` do not exist: the path-length count costs
    one register add per round, so it is always kept.  `max_rounds` (the
    reference's probe cap) is taken by the culled loop only, for
    `tools.livechunks`, which reads the live-chunk count the culled kernel
    writes where the reference read its "livechunks" debug plane;
  * lanes are padded to a multiple of 128, not to 1,024-lane tiles.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from bevy_raytrace_tpu_torch.config import RenderConfig
from bevy_raytrace_tpu_torch.kernels import build
from bevy_raytrace_tpu_torch.kernels.clusters import (
    check_plan,
    priority_rows,
    sphere_bounds,
)
from bevy_raytrace_tpu_torch.kernels.common import (
    FORWARD_TABLE_MODES,
    _pcg4d,
    _plain_camera,
    _plain_scatter,
    _to_unit,
    check_table_mode,
    forward_table_mode,
)
from bevy_raytrace_tpu_torch.utils.spans import count, span
from bevy_raytrace_tpu_torch.wavefront.render import frame_seed

LANE_ALIGN = 128
# Float elements of one [lanes, spheres] temporary in the twin's sweep: the
# twin steps through the lanes in chunks that keep each temporary this size.
_PLAIN_WORKSPACE = {"cpu": 1 << 22, "cuda": 1 << 26}
# t_ub of a lane that no priority sphere or previous winner bounds (the
# reference's 1e30).
_NO_BOUND = 1e30
# The culled bound test's slack in units of u = 2^-24: csrc/k1_render.cu's
# BRT_K1_CULL_SLACK, which a test holds equal to this.
CULL_SLACK = 32


class CullTables(NamedTuple):
    """The culled traversal's operands beside the rows in the plan's order.

    bounds: float32 [C, 4], chunk c's bounding sphere (bx, by, bz, br^2);
    members: int32 [S], the scene index of each row (a permutation);
    row_of: int32 [S], the row of each scene index (members' inverse);
    prio: float32 [K, 4], the priority spheres' (cx, cy, cz, r^2);
    cluster_size: L, chunk c owns rows [c L, min((c + 1) L, S))."""

    bounds: torch.Tensor
    members: torch.Tensor
    row_of: torch.Tensor
    prio: torch.Tensor
    cluster_size: int


@torch.no_grad()
def _scene_tables(scene, plan=None):
    """Scene -> (geom [S,4], attr [S,8]) float32, on the scene's device.

    geom row: (cx, cy, cz, r^2).  attr row: (1/r, albedo r, g, b, kind,
    fuzz, ior, 0); 1/r keeps the radius sign (hollow glass).  An empty scene
    gets one row that no ray can hit (r^2 = -1).

    With `plan` (a `ClusterPlan` of this scene's sphere count) -> (geom,
    attr, CullTables): the rows gathered into the plan's Morton order
    without its pad slots, the chunks' bounds (bx, by, bz, br^2) and the
    priority rows from the live geometry, and the row -> scene index map
    and its inverse."""
    c, r = scene.centers, scene.radii
    if plan is not None:
        check_plan(plan, scene.count)
        geom, attr = _scene_tables(scene)
        members = plan.on(geom.device)[0][:scene.count]
        row_of = torch.empty_like(members)
        row_of[members] = torch.arange(scene.count, device=members.device)
        return (geom[members].contiguous(), attr[members].contiguous(),
                CullTables(sphere_bounds(c, r, plan),
                           members.to(torch.int32).contiguous(),
                           row_of.to(torch.int32).contiguous(),
                           priority_rows(c, r, plan), plan.cluster_size))
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
                       height: int, cull=None, count_live: bool = False,
                       max_rounds: int = 0):
    """K1 in tensor ops, on any device: same inputs and outputs as
    `render_lanes`.  Vectorized over lanes, in chunks that bound the
    [lanes, spheres] workspace; loops samples and bounces with alive masks,
    with the kernel's arithmetic in the kernel's order.

    With `cull` (rows in the plan's order) the twin runs the culled
    traversal as masks: it puts the rows back in scene order, sweeps them
    as the dense twin does, and keeps only the roots of the members of the
    chunks each lane's bound test passes, so a first-index min is the
    kernel's (t, scene index) rule.  The lane's previous winner is carried
    in (sample, bounce) order, as the refill schedule meets it."""
    n = pids.shape[0]
    fb = torch.zeros((n, 3), dtype=torch.float32, device=pids.device)
    ln = torch.zeros((n,), dtype=torch.float32, device=pids.device)
    live = torch.zeros((n,), dtype=torch.float32, device=pids.device)
    chunk_cull = None
    if cull is not None:
        rows = cull.members.long()
        scene_geom, scene_attr = torch.empty_like(geom), torch.empty_like(attr)
        scene_geom[rows], scene_attr[rows] = geom, attr
        geom, attr = scene_geom, scene_attr
        chunk_of = torch.empty_like(rows)
        chunk_of[rows] = torch.arange(rows.shape[0], device=rows.device
                                      ) // cull.cluster_size
        chunk_cull = (cull.bounds, chunk_of, cull.prio)
    budget = _PLAIN_WORKSPACE.get(pids.device.type, _PLAIN_WORKSPACE["cpu"])
    chunk = max(budget // geom.shape[0] // LANE_ALIGN, 1) * LANE_ALIGN
    for lo in range(0, n, chunk):
        fb[lo:lo + chunk], ln[lo:lo + chunk], live[lo:lo + chunk] = \
            _plain_chunk(geom, attr, cam, pids[lo:lo + chunk].to(torch.int64),
                         seed, sample_base, spp, max_depth, t_min, width,
                         height, cull=chunk_cull, max_rounds=max_rounds)
    return (fb, ln, live) if count_live else (fb, ln)


def _plain_root(gx, gy, gz, gr2, ox, oy, oz, dx, dy, dz, t_min):
    """The sweep's root of spheres (gx, gy, gz, gr2) for rays (o, d), on
    broadcast planes: brt::sweep_root in tensor ops (NaN on a miss)."""
    ocx, ocy, ocz = ox - gx, oy - gy, oz - gz
    hb = ocx * dx + ocy * dy + ocz * dz
    cq = (ocx * ocx + ocy * ocy + ocz * ocz) - gr2
    disc = hb * hb - cq
    sq = disc * torch.rsqrt(disc)  # NaN (a miss) for disc <= 0
    rn = -hb - sq
    return torch.where(rn > t_min, rn, sq - hb)


def _chunk_live(bx, by, bz, br2, ox, oy, oz, dx, dy, dz, t_min, t_ub):
    """Whether each ray (o, d) may meet a member of the chunk bounded by (bx,
    by, bz, br2) in [t_min, t_ub], on broadcast planes: the culled kernel's
    `chunk_live` in tensor ops (each operation rounded, no fma).  The point
    v of the segment nearest the bound's center passes when |v|^2 <= br^2 +
    CULL_SLACK u (|v|^2 + hb^2), u = 2^-24: the slack covers the grazing
    hits the member test's rounding takes just outside a sphere."""
    bocx, bocy, bocz = ox - bx, oy - by, oz - bz
    bhb = bocz * dz + bocy * dy + bocx * dx
    ts = torch.minimum(torch.clamp(-bhb, min=t_min), t_ub)
    vx, vy, vz = ts * dx + bocx, ts * dy + bocy, ts * dz + bocz
    v2 = vz * vz + vy * vy + vx * vx
    return v2 <= CULL_SLACK * 2.0 ** -24 * (bhb * bhb + v2) + br2


def _live_chunks(bounds, prio, geom, prev, ox, oy, oz, dx, dy, dz, t_min):
    """[n, C] bool: the chunks whose bound each ray may hit before its t_ub
    (the nearest valid root among the priority rows and the row `prev` of
    the lane's previous winner, -1 = none): the culled kernel's phase A."""
    t_ub = torch.full_like(ox, _NO_BOUND)
    rows = [prio[k] for k in range(prio.shape[0])]
    rows.append(torch.where((prev >= 0)[:, None], geom[prev.clamp(min=0)],
                            math.nan))
    for g in rows:
        t = _plain_root(*g.unbind(-1), ox, oy, oz, dx, dy, dz, t_min)
        t_ub = torch.where((t > t_min) & (t < t_ub), t, t_ub)
    return _chunk_live(*bounds.T.contiguous().unbind(0), ox[:, None],
                       oy[:, None], oz[:, None], dx[:, None], dy[:, None],
                       dz[:, None], t_min, t_ub[:, None])


def _plain_chunk(geom, attr, cam, pid, seed, sample_base, spp, max_depth,
                 t_min, width, height, res=None, res2=None, cull=None,
                 max_rounds=0):
    """One chunk of lanes -> (radiance sums [n, 3], executed rounds [n],
    live chunks summed over the rounds [n]).

    With `res` ([spp, max_depth, n] int, written in place) the sweep also
    records each round's winner index, -1 for a miss or a dead path, and
    with `res2` the runner-up (the nearest valid root farther than the
    winner's): K4's recording (`kernels/sweep_record.py`), which shares
    this body as its kernel shares K1's.  `cull` = (bounds, the scene
    index -> chunk map, prio) runs the culled traversal on scene-ordered
    rows; `max_rounds` > 0 stops a lane after that many rounds."""
    where = torch.where
    gx, gy, gz, gr2 = geom.T.contiguous().unbind(0)
    zero = torch.zeros(pid.shape, dtype=torch.float32, device=pid.device)
    acc_r, acc_g, acc_b, rounds, live = zero, zero, zero, zero, zero
    prev = torch.full(pid.shape, -1, dtype=torch.int64, device=pid.device)

    for s in range(spp):
        su = sample_base + s
        # ---- camera ray (thin lens) ------------------------------------
        ox, oy, oz, dx, dy, dz = _plain_camera(cam, pid, su, seed, width,
                                               height)
        tp_r, tp_g, tp_b = zero + 1.0, zero + 1.0, zero + 1.0
        alive = torch.ones_like(zero, dtype=torch.bool)

        for bounce in range(max_depth):
            if max_rounds:  # a lane stops after max_rounds rounds
                alive = alive & (rounds < max_rounds)
            if bounce and not bool(alive.any()):
                if res is not None:  # every path is dead: -1 from here on
                    res[s, bounce:] = -1
                if res2 is not None:
                    res2[s, bounce:] = -1
                break
            rounds = rounds + alive.to(torch.float32)
            # ---- dense sweep: nearest hit, first index wins ties -------
            tn = _plain_root(gx, gy, gz, gr2, ox[:, None], oy[:, None],
                             oz[:, None], dx[:, None], dy[:, None],
                             dz[:, None], t_min)
            tn = where(tn > t_min, tn, math.inf)
            if cull is not None:  # ---- only the members of live chunks
                bounds, chunk_of, prio = cull
                live_c = _live_chunks(bounds, prio, geom, prev, ox, oy, oz,
                                      dx, dy, dz, t_min)
                live = live + where(alive, live_c.sum(1).to(torch.float32),
                                    0.0)
                tn = where(live_c[:, chunk_of], tn, math.inf)
            best_t, best = torch.min(tn, dim=1)
            hit = best_t < math.inf
            if cull is not None:
                prev = where(alive & hit, best, prev)
            if res is not None:
                res[s, bounce] = where(hit & alive, best, -1).to(res.dtype)
            if res2 is not None:
                t2, best2 = torch.min(
                    where(tn > best_t[:, None], tn, math.inf), dim=1)
                res2[s, bounce] = where(hit & (t2 < math.inf) & alive, best2,
                                        -1).to(res2.dtype)

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
    return torch.stack([acc_r, acc_g, acc_b], dim=1), rounds, live


# --- the wrapper ----------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _k1_launcher():
    lib = build.load("k1_render")
    fn = lib.brt_k1_render
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, i32, vp, vp, i32, vp, vp, ctypes.c_uint,
                   ctypes.c_uint, i32, i32, ctypes.c_float, i32, i32, i32, vp]
    fn.restype = i32
    return fn


@functools.lru_cache(maxsize=1)
def _k1_culled_launcher():
    fn = build.load("k1_render").brt_k1_render_culled
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, i32, vp, vp, vp, vp, i32, i32, i32, vp, vp, i32, vp,
                   vp, vp, ctypes.c_uint, ctypes.c_uint, i32, i32,
                   ctypes.c_float, i32, i32, i32, i32, vp]
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


def _check_cull(cull, n_spheres, device):
    """Refuse culled operands that do not fit `n_spheres` rows."""
    if not isinstance(cull, CullTables):
        raise TypeError(f"cull must be a render_lanes.CullTables, got "
                        f"{type(cull).__name__}")
    size = cull.cluster_size
    if not isinstance(size, int) or size < 1:
        raise ValueError(f"cluster_size must be an int >= 1, got {size!r}")
    _check("bounds", cull.bounds, torch.float32,
           (-(-n_spheres // size), 4), device)
    _check("members", cull.members, torch.int32, (n_spheres,), device)
    _check("row_of", cull.row_of, torch.int32, (n_spheres,), device)
    _check("prio", cull.prio, torch.float32, (None, 4), device)


def render_lanes(geom, attr, cam, pids, seed: int, sample_base: int, spp: int,
                 max_depth: int, t_min: float, width: int, height: int,
                 table_mode=None, cull=None, count_live: bool = False,
                 max_rounds: int = 0):
    """K1: render the absolute pixel ids `pids` [n] int32, one per lane.

    geom [S,4] and attr [S,8] float32 are `_scene_tables(scene)`; cam [16]
    float32 is `Camera.pack()`; seed is the frame's 32-bit seed counter;
    samples are [sample_base, sample_base + spp).  Returns (fb [n,3],
    len [n]): per-lane radiance and executed-round sums over the samples
    (not yet divided by spp).  n must be a multiple of 128.  `table_mode`
    None takes `forward_table_plan`'s mode; "shared" or "global" forces one
    (a shared table too large for a block raises).

    `cull` (a `CullTables`, with geom and attr in the plan's order:
    `_scene_tables(scene, plan)`) runs the chunk-culled traversal, whose
    image and len equal the dense sweep's on the scene-ordered rows;
    `count_live` then also returns live [n], each lane's live chunks summed
    over its rounds, and `max_rounds` > 0 stops a lane after that many
    rounds (both need `cull`).

    CUDA tensors launch the kernel (and count one in the counter
    `k1.launches`, in `k1.launches_global` when the rows are read from
    device memory, and in `k1.launches_culled` when culled); CPU tensors
    run `render_lanes_plain`; any other device raises.  The span
    `k1.launch` covers it, checks and launch."""
    with span("k1.launch"):
        device = pids.device
        check_table_mode(table_mode)
        _check("pids", pids, torch.int32, (None,), device)
        n_spheres = geom.shape[0] if isinstance(geom, torch.Tensor) else 0
        _check("geom", geom, torch.float32, (n_spheres, 4), device)
        _check("attr", attr, torch.float32, (n_spheres, 8), device)
        _check("cam", cam, torch.float32, (16,), device)
        n = pids.shape[0]
        if n % LANE_ALIGN or n_spheres == 0:
            raise ValueError(f"need a multiple of {LANE_ALIGN} lanes (got "
                             f"{n}) and at least one sphere row (got "
                             f"{n_spheres})")
        if not (0 <= seed < 2**32 and 0 <= sample_base < 2**32 and spp >= 0
                and max_depth >= 0 and width > 0 and height > 0):
            raise ValueError("seed/sample_base must be 32-bit unsigned; spp, "
                             "max_depth >= 0; width, height > 0")
        if cull is None:
            if count_live or max_rounds:
                raise ValueError("count_live and max_rounds need cull")
        else:
            _check_cull(cull, n_spheres, device)
            if not 0 <= max_rounds < 2**24:
                raise ValueError(f"max_rounds must be in [0, 2^24), got "
                                 f"{max_rounds}")
        if device.type == "cpu":
            return render_lanes_plain(geom, attr, cam, pids, seed,
                                      sample_base, spp, max_depth, t_min,
                                      width, height, cull, count_live,
                                      max_rounds)
        if device.type != "cuda":
            raise ValueError(f"K1 runs on CUDA (or its twin on CPU), not "
                             f"{device}")
        fb = torch.empty((n, 3), dtype=torch.float32, device=device)
        ln = torch.empty((n,), dtype=torch.float32, device=device)
        live = (torch.empty((n,), dtype=torch.float32, device=device)
                if count_live else None)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            if cull is None:
                mode = forward_table_mode("k1_render", device, n_spheres,
                                          table_mode)
                err = _k1_launcher()(
                    geom.data_ptr(), attr.data_ptr(), n_spheres,
                    cam.data_ptr(), pids.data_ptr(), n, fb.data_ptr(),
                    ln.data_ptr(), seed, sample_base, spp, max_depth, t_min,
                    width, height, FORWARD_TABLE_MODES.index(mode), stream)
            else:
                n_chunks, n_prio = cull.bounds.shape[0], cull.prio.shape[0]
                mode = forward_table_mode("k1_render_culled", device,
                                          n_spheres + n_chunks + n_prio,
                                          table_mode)
                err = _k1_culled_launcher()(
                    geom.data_ptr(), attr.data_ptr(), n_spheres,
                    cull.bounds.data_ptr(), cull.members.data_ptr(),
                    cull.row_of.data_ptr(),
                    cull.prio.data_ptr() if n_prio else 0, n_chunks,
                    cull.cluster_size, n_prio, cam.data_ptr(),
                    pids.data_ptr(), n, fb.data_ptr(), ln.data_ptr(),
                    0 if live is None else live.data_ptr(), seed,
                    sample_base, spp, max_depth, t_min, width, height,
                    max_rounds, FORWARD_TABLE_MODES.index(mode), stream)
        if err != 0:
            raise RuntimeError(f"K1 {'culled ' if cull is not None else ''}"
                               f"launch ({mode} table) failed with "
                               f"cudaError_t {err}")
        count("k1.launches")
        if mode == "global":
            count("k1.launches_global")
        if cull is not None:
            count("k1.launches_culled")
        return (fb, ln, live) if count_live else (fb, ln)


# --- host side ----------------------------------------------------------


def render_mxu_lanes(scene, camera, config: RenderConfig, pid_grid, frame=0,
                     sample_base: int = 0, plan=None):
    """Raw lane-slot render: `pid_grid` int32 [rows, 128] holds the
    ABSOLUTE pixel id of each lane.  Returns (fb [p, 3], len [p]) in
    lane-slot order, divided by spp.  `plan` (a `ClusterPlan` of this
    scene's sphere count) runs the chunk-culled traversal: the same bits."""
    with span("k1.tables"):
        tables = _scene_tables(scene, plan)
        cam = camera.pack().contiguous()
        seed = frame_seed(config, frame)
    fb, ln = render_lanes(
        *tables[:2], cam, pid_grid.reshape(-1), seed, sample_base,
        config.samples_per_pixel, config.max_depth, config.t_min,
        config.width, config.height,
        cull=tables[2] if plan is not None else None)
    inv_spp = float(np.float32(1.0 / config.samples_per_pixel))
    return fb * inv_spp, ln * inv_spp


def lane_pad(num_pixels: int) -> int:
    """Lane-slot count for `num_pixels` (a multiple of 128)."""
    return -(-num_pixels // LANE_ALIGN) * LANE_ALIGN


def render_mxu_with_len(scene, camera, config: RenderConfig, frame=0,
                        perm=None, sample_base: int = 0, plan=None):
    """Forward render on K1 -> (image [H, W, 3], mean path length [H, W]).

    `perm`: optional int32 [num_pixels] permutation of absolute pixel ids
    (from `balance_perm`); lane i renders perm[i] and the result is
    scattered back, so the image is bit-identical for any perm.  `plan`: a
    `ClusterPlan` for the chunk-culled traversal (the same bits)."""
    n = config.num_pixels
    dev = scene.device
    if plan is not None:
        check_plan(plan, scene.count)
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
                              pids.reshape(-1, LANE_ALIGN), frame, sample_base,
                              plan)
    with span("k1.scatter"):
        idx = pids[:n].long()
        img = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        img[idx] = fb[:n]
        lmap = torch.zeros((n,), dtype=torch.float32, device=dev)
        lmap[idx] = ln[:n]
        return (img.reshape(config.height, config.width, 3),
                lmap.reshape(config.height, config.width))


def render_mxu(scene, camera, config: RenderConfig, frame=0, perm=None,
               plan=None):
    """Forward render on K1 -> linear float32 [H, W, 3]."""
    return render_mxu_with_len(scene, camera, config, frame, perm=perm,
                               plan=plan)[0]


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


def balance_perm(len_map, coherent: bool = True, quant: float = 2.0):
    """Pixel permutation sorting by measured path length [H, W].

    Pixels of one warp then share a similar per-sample cost, so few lanes
    idle while the slowest finishes.  `coherent` (the default): the cost is
    quantized to 1/`quant` round and ties break along the Morton curve, so
    warps stay spatially compact (what keeps the culled traversal's live
    chunks few).  Else a plain stable sort of the cost: equal costs keep
    raster order, as `jnp.argsort` keeps them."""
    ln = len_map.reshape(-1)
    if not coherent:
        return torch.argsort(ln, stable=True).to(torch.int32)
    h, w = len_map.shape
    rank = torch.from_numpy(_morton_rank(h, w)).to(len_map.device,
                                                   torch.int64)
    scaled = ln * torch.tensor(quant, dtype=torch.float32, device=ln.device)
    key = torch.round(scaled).to(torch.int64) * (h * w)
    return torch.argsort(key + rank).to(torch.int32)


def render_probed(scene, camera, config: RenderConfig, frame=0,
                  probe_spp: int = 16, plan=None):
    """Probe -> balance_perm -> the rest of the samples on the perm.

    The probe renders samples [0, probe_spp) in identity layout and its
    samples count; the balanced pass renders [probe_spp, spp).  Every path
    is the plain render's; only the per-pixel summation is split in two.
    `plan`: both passes culled (the same bits as without).  Returns (image
    [H, W, 3], perm)."""
    spp = config.samples_per_pixel
    probe_spp = min(probe_spp, spp)
    probe_img, len_map = render_mxu_with_len(
        scene, camera, config.replace(samples_per_pixel=probe_spp,
                                      spp_chunk=0), frame, plan=plan)
    perm = balance_perm(len_map)
    rest = spp - probe_spp
    if rest == 0:
        return probe_img, perm
    rest_img, _ = render_mxu_with_len(
        scene, camera, config.replace(samples_per_pixel=rest, spp_chunk=0),
        frame, perm=perm, sample_base=probe_spp, plan=plan)
    w = np.float32(1.0 / spp)
    return (probe_img * float(w * np.float32(probe_spp))
            + rest_img * float(w * np.float32(rest))), perm


def render_mxu_balanced(scene, camera, config: RenderConfig, frame=0,
                        probe_spp: int = 16, probe_reuse: bool = True,
                        plan=None):
    """Cost-balanced forward render -> linear float32 [H, W, 3].

    With `probe_reuse` (the default) the probe's samples count: probe, then
    the rest on the sorted perm (`render_probed`); allclose to the plain
    render, whose paths it traces.  With probe_reuse=False the probe only
    measures: every sample is rendered on the perm, bit for bit the plain
    render.  `plan`: every pass culled (the same bits as without)."""
    if probe_reuse:
        return render_probed(scene, camera, config, frame, probe_spp,
                             plan)[0]
    probe_spp = min(probe_spp, config.samples_per_pixel)
    _, len_map = render_mxu_with_len(
        scene, camera, config.replace(samples_per_pixel=probe_spp,
                                      spp_chunk=0), frame, plan=plan)
    return render_mxu(scene, camera, config, frame,
                      perm=balance_perm(len_map), plan=plan)
