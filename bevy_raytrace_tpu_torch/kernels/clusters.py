"""Sphere clustering for the culled traversals of K2 and K1.

Mirror of `bevy_raytrace_tpu/kernels/clusters.py`.

  plan (host, once per scene topology):
      order the spheres along a Morton curve of their (x, z) centers and
      chop the order into fixed-size clusters: spatially coherent groups
      with a static membership (a permutation + pad mask).  Membership is
      static; the BOUNDS are recomputed from live sphere positions on every
      render (`cluster_bounds`, a few small tensor ops on the scene's
      device), so inverse-rendering updates and moved spheres stay correct
      without a new plan.

  kernels (`csrc/k2_record.cu`, `csrc/k1_render.cu`, per ray, per bounce):
      the ray is tested against each cluster's bounding sphere; the
      per-sphere loop then visits only the members of the clusters it hits
      (K1: only those whose bound starts before the nearest hit of the
      priority spheres and of the lane's previous winner).

Bounds come in two encodings, one for each kernel's quadratic:
`cluster_bounds` gives K2's (bx, by, bz, |b|^2 - br^2), `sphere_bounds`
K1's (bx, by, bz, br^2) with br^2 squared directly, not recovered from
|b|^2 - kq as the reference's K1 operands are (that difference cancels
badly for a small bound far from the origin), and beside each chunk the
factor its bound test's slack is scaled by (br / r_min at most; 1 for a
chunk of one sphere).  `priority_rows` gives the
live (cx, cy, cz, r^2) of the plan's priority spheres.

The plan's arrays equal the reference's exactly (same numpy arithmetic);
`interop.cluster_plan_from_reference` carries one across.  Pad slots of the
last cluster repeat the last real sphere, as the reference's do; the Hopper
kernels do not visit them.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def _morton2(x: np.ndarray, y: np.ndarray, bits: int = 16) -> np.ndarray:
    """Interleave two quantized coordinates into a Morton code."""

    def part(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x0000FFFF0000FFFF)
        v = (v | (v << 8)) & np.uint64(0x00FF00FF00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x3333333333333333)
        v = (v | (v << 1)) & np.uint64(0x5555555555555555)
        return v

    return part(x) | (part(y) << np.uint64(1))


@dataclasses.dataclass(frozen=True, eq=False)
class ClusterPlan:
    """Static traversal plan: permutation + pad mask + sizes (numpy)."""

    perm: np.ndarray  # [C*L] int32, indices into the scene (duplicated pad)
    member_mask: np.ndarray  # [C, L] float32, 1 = real member, 0 = pad
    prio: np.ndarray  # [K] int32, the spheres of largest |r|
    cluster_size: int
    n_clusters: int
    # device -> (perm int64 [C*L], member_mask [C, L]) tensors, filled by
    # `on`: the plan is uploaded once per device, not once per frame.
    _tensors: dict = dataclasses.field(default_factory=dict, repr=False)

    @functools.cached_property
    def n_members(self) -> int:
        """The real (unpadded) member count: the scene's sphere count
        (summed once; every launch checks it against its scene)."""
        return int(self.member_mask.sum())

    def on(self, device):
        """(perm int64 [C*L], member_mask float32 [C, L]) on `device`."""
        device = torch.device(device)
        got = self._tensors.get(device)
        if got is None:
            got = (torch.from_numpy(self.perm).to(device, torch.int64),
                   torch.from_numpy(self.member_mask).to(device))
            self._tensors[device] = got
        return got


def cluster_scene(scene, cluster_size: int = 12, n_prio: int = 4
                  ) -> ClusterPlan:
    """Build a ClusterPlan from a scene's current centers (host numpy).

    Spheres are sorted by the Morton code of their quantized (x, z) center
    (the scenes spread on the ground plane; y adds nothing) and chopped
    into groups of `cluster_size`.  The permutation is static; call again
    only when the sphere count changes (or after large motion, to tighten
    the bounds)."""
    if cluster_size < 1:
        raise ValueError(f"cluster_size must be >= 1, got {cluster_size}")
    centers = scene.centers.detach().cpu().numpy()
    n = centers.shape[0]
    if n < 1:
        raise ValueError("cannot cluster an empty scene")
    lo = centers.min(axis=0)
    hi = centers.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    qx = np.clip((centers[:, 0] - lo[0]) / span[0] * 65535, 0, 65535)
    qz = np.clip((centers[:, 2] - lo[2]) / span[2] * 65535, 0, 65535)
    order = np.argsort(_morton2(qx.astype(np.uint32), qz.astype(np.uint32)))

    L = cluster_size
    C = -(-n // L)
    perm = np.empty(C * L, np.int32)
    mask = np.zeros((C, L), np.float32)
    perm[:n] = order
    mask.reshape(-1)[:n] = 1.0
    perm[n:] = order[-1]  # pad slots repeat the last real sphere
    radii = np.abs(scene.radii.detach().cpu().numpy())
    prio = np.argsort(-radii, kind="stable")[: min(n_prio, n)].astype(np.int32)
    return ClusterPlan(
        perm=perm, member_mask=mask, prio=prio, cluster_size=L, n_clusters=C
    )


def check_plan(plan, n_spheres=None) -> None:
    """Raise unless `plan` is a ClusterPlan (for a scene of `n_spheres`,
    when given)."""
    if not isinstance(plan, ClusterPlan):
        raise TypeError(
            f"clusters must be a kernels.clusters.ClusterPlan, got "
            f"{type(plan).__name__}")
    if n_spheres is not None and plan.n_members != n_spheres:
        raise ValueError(
            f"the cluster plan was built for {plan.n_members} spheres, the "
            f"scene has {n_spheres}")


def _bounding_spheres(centers, radii, plan: ClusterPlan):
    """(bc [C, 3], br [C]): each cluster's bounding sphere from live
    geometry, its radius widened by 1.0001 and 1e-4 so that a bound test's
    rounding cannot cull a member the ray hits."""
    L, C = plan.cluster_size, plan.n_clusters
    perm, m = plan.on(centers.device)  # [C*L], [C, L]
    c = centers[perm].reshape(C, L, 3)
    r = radii[perm].abs().reshape(C, L)
    count = m.sum(dim=1, keepdim=True)
    bc = (c * m[:, :, None]).sum(dim=1) / count  # [C, 3]
    d = torch.sqrt(((c - bc[:, None, :]) ** 2).sum(dim=-1)) + r  # [C, L]
    br = torch.where(m > 0, d, -torch.inf).max(dim=1).values * 1.0001 + 1e-4
    return bc, br


def cluster_bounds(centers, radii, plan: ClusterPlan):
    """Per-cluster bounding spheres from live geometry, on its device.

    centers [S, 3], radii [S] tensors.  Returns (bcx, bcy, bcz, kq), each
    [C], where kq = |bc|^2 - br^2 is the expanded-quadratic constant of the
    kernel's bound test."""
    bc, br = _bounding_spheres(centers, radii, plan)
    kq = (bc * bc).sum(dim=-1) - br * br
    return bc[:, 0], bc[:, 1], bc[:, 2], kq


def sphere_bounds(centers, radii, plan: ClusterPlan):
    """K1's chunk bounds -> (float32 [C, 4] rows (bx, by, bz, br^2), float32
    [C] slack factors), for the centered quadratic of K1's bound test.

    A chunk's factor F is 1 + max |c - b| / |r| over its real members
    (times the 1.0001 of `_bounding_spheres`): at least (|c - b| + r) / r
    for every member, so at most br / r_min, and exactly 1 for a chunk of
    one member, whose bound center is its center bit for bit.  The bound
    test scales its slack by F, and the bound's radius is that of
    `cluster_bounds` times 1 + 160 u (F - 1), u = 2^-24: both as
    csrc/k1_render.cu's `chunk_live` derives them, so that the test keeps
    every chunk whose member the member test's rounding calls hit, however
    small that member is beside its chunk.  At cluster size 1 every factor
    is 1 and the rows are `cluster_bounds`' spheres.  A member of radius 0
    gives the factor's cap, 2^64, which keeps its chunk live."""
    bc, br = _bounding_spheres(centers, radii, plan)
    L, C = plan.cluster_size, plan.n_clusters
    perm, m = plan.on(centers.device)
    c = centers[perm].reshape(C, L, 3)
    r = radii[perm].abs().reshape(C, L)
    g = torch.sqrt(((c - bc[:, None, :]) ** 2).sum(dim=-1))  # [C, L]
    ratio = torch.where((m > 0) & (g > 0), g / r, 0.0)
    factor = torch.clamp(1.0 + ratio.max(dim=1).values * 1.0001,
                         max=2.0 ** 64)
    br = br * (1.0 + 160 * 2.0 ** -24 * (factor - 1.0))
    return (torch.cat([bc, (br * br)[:, None]], dim=1).contiguous(),
            factor.contiguous())


def priority_rows(centers, radii, plan: ClusterPlan):
    """float32 [K, 4] rows (cx, cy, cz, r^2) of the plan's priority spheres
    (`plan.prio`, the K of largest |r|), read from live geometry: r^2 is
    r * r, the same float as the sphere's own row in K1's table."""
    pk = torch.from_numpy(plan.prio).to(centers.device, torch.int64)
    r = radii[pk]
    return torch.cat([centers[pk], (r * r)[:, None]], dim=1).contiguous()
