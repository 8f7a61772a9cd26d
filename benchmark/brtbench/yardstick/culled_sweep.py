"""The work of K1's chunk-culled sweep (`k1_culled_kernel`), counted as the
least that any one-level cull of the plan must do on the paths the plain
reference traces.

Per executed (path, bounce) round: the test of every chunk's bound (16
float32 operations, as a sphere test in forward_sweep.py), and the member
tests (16 each) of every chunk whose bound the round's segment [t_min,
t_hit] enters, t_hit the round's nearest hit (the whole ray on a miss):
such a chunk may hold a nearer hit, so a cull that skips it cannot know
the winner.  Plus forward_sweep.py's round (hit frame, scatter, sky: 120)
and camera (70) terms.  Bytes: the sphere tables (48 a sphere), the chunk
bounds (16 a chunk), the camera, the image and K1's pixel ids and path
lengths, as forward_sweep.py counts them.  So the count depends on the
paths and the plan, not on how a kernel schedules its pairs, and a correct
kernel cannot beat it.

The plan is this module's own frozen copy of the port's `cluster_scene`
(kernels/clusters.py at the time of writing): the spheres in the Morton
order of their (x, z) centers, quantized to 16 bits over the scene's
extent, chopped into chunks of L; each chunk's bound the least sphere about
its members' centroid.  A change to the port's plan rule, or a second level
of the cull, needs a `benchmark` change to count again first.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from brtbench import reference
from brtbench.yardstick.forward_sweep import (
    CAMERA_FLOPS,
    ROUND_FLOPS,
    SWEEP_FLOPS,
)
from brtbench.yardstick.peaks import bound_seconds

# Elements of one [lanes, chunks] plane of the count.
_WORKSPACE = {"cpu": 1 << 22, "cuda": 1 << 26}


def _morton2(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    def part(v):
        v = v.astype(np.uint64)
        for shift, mask in ((16, 0x0000FFFF0000FFFF), (8, 0x00FF00FF00FF00FF),
                            (4, 0x0F0F0F0F0F0F0F0F), (2, 0x3333333333333333),
                            (1, 0x5555555555555555)):
            v = (v | (v << np.uint64(shift))) & np.uint64(mask)
        return v

    return part(x) | (part(y) << np.uint64(1))


def plan_order(centers: np.ndarray) -> np.ndarray:
    """The spheres' order along the Morton curve of their quantized (x, z)
    centers: the port's plan rule, frozen."""
    lo, hi = centers.min(axis=0), centers.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    q = [np.clip((centers[:, i] - lo[i]) / span[i] * 65535, 0,
                 65535).astype(np.uint32) for i in (0, 2)]
    return np.argsort(_morton2(*q))


def chunk_bounds(centers: torch.Tensor, radii: torch.Tensor, size: int):
    """Each chunk's least bounding sphere about its members' centroid and
    its member count -> (center [C, 3], radius [C], members [C])."""
    order = torch.from_numpy(plan_order(centers.detach().cpu().numpy())).to(
        centers.device)
    n = order.shape[0]
    chunks = -(-n // size)
    chunk = torch.arange(n, device=centers.device) // size
    c = centers[order].to(torch.float64)
    r = radii[order].abs().to(torch.float64)
    members = torch.bincount(chunk, minlength=chunks)
    bc = torch.zeros((chunks, 3), dtype=torch.float64, device=c.device)
    bc.index_add_(0, chunk, c)
    bc /= members[:, None]
    reach = torch.linalg.norm(c - bc[chunk], dim=1) + r
    br = torch.full((chunks,), -math.inf, dtype=torch.float64,
                    device=c.device).scatter_reduce(0, chunk, reach, "amax")
    return bc, br, members


def _entered(bc, br, ox, oy, oz, dx, dy, dz, t_hit):
    """[n, C] bool: whether each ray's segment [t_min, t_hit] comes within
    each bound (float64)."""
    o = torch.stack([ox, oy, oz], dim=1).to(torch.float64)
    d = torch.stack([dx, dy, dz], dim=1).to(torch.float64)
    ob = o[:, None, :] - bc[None]  # [n, C, 3]
    hb = (ob * d[:, None, :]).sum(-1) / (d * d).sum(-1, keepdim=True)
    ts = torch.minimum(torch.clamp(-hb, min=reference.T_MIN),
                       t_hit.to(torch.float64)[:, None])
    v = ob + ts[..., None] * d[:, None, :]
    return (v * v).sum(-1) <= br[None] ** 2


def _count(geom, attr, bounds, cam, pid, sample, seed, max_depth, width,
           height):
    """The reference's paths (`reference._paths`, the same steps in its
    float32 order) -> (rounds [n], members of the entered chunks summed
    over the rounds [n])."""
    where = torch.where
    bc, br, members = bounds
    gx, gy, gz, gr2 = geom.T.contiguous().unbind(0)
    f32 = torch.float32
    ox, oy, oz, dx, dy, dz = reference._camera_rays(
        cam, pid, sample, seed, width, height, f32)
    rounds = torch.zeros(pid.shape, dtype=f32, device=pid.device)
    swept = torch.zeros(pid.shape, dtype=torch.float64, device=pid.device)
    alive = torch.ones(pid.shape, dtype=torch.bool, device=pid.device)
    for bounce in range(max_depth):
        if bounce and not bool(alive.any()):
            break
        rounds = rounds + alive.to(f32)
        tn = reference._root(gx, gy, gz, gr2, ox[:, None], oy[:, None],
                             oz[:, None], dx[:, None], dy[:, None],
                             dz[:, None])
        tn = where(tn > reference.T_MIN, tn, math.inf)
        best_t, best = torch.min(tn, dim=1)
        hit = best_t < math.inf
        live = _entered(bc, br, ox, oy, oz, dx, dy, dz, best_t)
        swept += where(alive, (live * members[None]).sum(1).to(
            torch.float64), 0.0)

        bcx, bcy, bcz, b_r2 = geom[best].unbind(1)
        _, _, _, _, bkd, bfz, bio = attr[best].unbind(1)
        rocx, rocy, rocz = ox - bcx, oy - bcy, oz - bcz
        hb = rocx * dx + rocy * dy + rocz * dz
        cq = (rocx * rocx + rocy * rocy + rocz * rocz) - b_r2
        sq = torch.sqrt(torch.clamp(hb * hb - cq, min=0.0))
        rn = -hb - sq
        bt = where(rn > reference.T_MIN, rn, sq - hb)
        t_safe = where(hit, bt, 0.0)
        hx, hy, hz = ox + t_safe * dx, oy + t_safe * dy, oz + t_safe * dz
        binv = attr[best][:, 0]
        nx = where(hit, (hx - bcx) * binv, 0.0)
        ny = where(hit, (hy - bcy) * binv, 0.0)
        nz = where(hit, (hz - bcz) * binv, 1.0)
        front = (dx * nx + dy * ny + dz * nz) < 0.0
        sgn = where(front, 1.0, -1.0)
        nx, ny, nz = nx * sgn, ny * sgn, nz * sgn
        sx, sy, sz, _, scat_ok = reference._scatter(
            dx, dy, dz, nx, ny, nz, front, bkd, bfz, bio,
            reference.uniforms(pid, sample, bounce, seed, f32))
        alive = alive & hit & scat_ok & (bounce + 1 < max_depth)
        ox, oy, oz = where(alive, hx, ox), where(alive, hy, oy), \
            where(alive, hz, oz)
        dx, dy, dz = where(alive, sx, dx), where(alive, sy, dy), \
            where(alive, sz, dz)
    return rounds, swept


@torch.no_grad()
def count_paths(scene, cams, pids, seeds, spp: int, max_depth: int,
                width: int, height: int, cluster_size: int):
    """The reference's paths of pixels `pids` (cams [n, 16], seeds [n], as
    `reference.render_pixels` takes them), samples [0, spp) -> (rounds
    [n], members of the chunks each round's segment enters, summed over
    the rounds [n]), per pixel."""
    dev = pids.device
    geom, attr = reference.tables(scene)
    bounds = chunk_bounds(scene.centers, scene.radii, cluster_size)
    n = pids.shape[0]
    pid = pids.to(torch.int64).repeat_interleave(spp)
    smp = torch.arange(spp, dtype=torch.int64, device=dev).repeat(n)
    sd = seeds.to(torch.int64).repeat_interleave(spp)
    row = torch.arange(n, device=dev).repeat_interleave(spp)
    budget = _WORKSPACE.get(dev.type, _WORKSPACE["cpu"])
    step = max(budget // max(geom.shape[0], 3 * bounds[1].shape[0]), 128)
    rounds = torch.empty(pid.shape, dtype=torch.float32, device=dev)
    swept = torch.empty(pid.shape, dtype=torch.float64, device=dev)
    for lo in range(0, pid.shape[0], step):
        hi = min(lo + step, pid.shape[0])
        rounds[lo:hi], swept[lo:hi] = _count(
            geom, attr, bounds, cams[row[lo:hi]], pid[lo:hi], smp[lo:hi],
            sd[lo:hi], max_depth, width, height)
    return rounds.reshape(n, spp).sum(1), swept.reshape(n, spp).sum(1)


def culled_work(n_spheres: int, n_chunks: int, n_pix: int, spp: int,
                rounds: float, members: float) -> tuple:
    """(flops, bytes) of one launch over n_pix pixels x spp samples whose
    paths took `rounds` rounds and whose rounds' segments entered chunks
    of `members` members in all."""
    flops = (rounds * (n_chunks * SWEEP_FLOPS + ROUND_FLOPS)
             + members * SWEEP_FLOPS + n_pix * spp * CAMERA_FLOPS)
    nbytes = n_spheres * 48 + n_chunks * 16 + 64 + n_pix * 12 + n_pix * 8
    return flops, nbytes


def culled_bound(n_spheres: int, n_chunks: int, n_pix: int, spp: int,
                 rounds: float, members: float) -> tuple:
    """(least seconds, what bounds it) of that launch on the card."""
    return bound_seconds(*culled_work(n_spheres, n_chunks, n_pix, spp, rounds,
                                      members))
