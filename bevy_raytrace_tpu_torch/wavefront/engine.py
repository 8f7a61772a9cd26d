"""Renderer session object: the frame-loop layer.

Mirror of `bevy_raytrace_tpu/wavefront/engine.py` for the port's
backends.  `Renderer` auto-advances the frame counter (RNG decorrelation),
accepts a new scene/camera every frame, and for the "cuda" backend keeps the
cost-balanced lane permutation between frames.  The "pallas" backend keeps
the cluster plans of K2's culled traversal, and the "cuda" backend asked to
cull (`cluster_size` > 0) those of K1's.  The sharded backends render this
process's pixel stripe and gather the image over the mesh.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from bevy_raytrace_tpu_torch.config import RenderConfig
from bevy_raytrace_tpu_torch.device import resolve
from bevy_raytrace_tpu_torch.utils.metrics import synchronize
from bevy_raytrace_tpu_torch.utils.spans import count, span

# Samples of the probe pass that measures the cost map (they count).
PROBE_SPP = 16
# The culling backends plan clusters for scenes of at least this many
# spheres, and keep at most this many plans.
MIN_CLUSTERED_SPHERES = 32
MAX_PLANS = 8


def culled_perm(scene, camera, config: RenderConfig, plan):
    """The lane order of a culled "cuda" session: the cost map of a probe of
    min(PROBE_SPP, spp) samples at seed 0 and frame 0 (its image is not
    used), balanced (`render_lanes.balance_perm`) and reversed, so the
    costliest lanes launch first.

    Both departures from the dense session's probe frame were measured on
    the SPD sphereflake (PERF.md, section 6): a culled frame there is about
    two waves of blocks of widely different cost, and balance_perm's rising
    order ended it on its costliest blocks (reversed: 0.70x the time); and
    its time depended on the draw of the permutation, 296-321 ms over six
    probe seeds, so a probe of the run's own seed made each run's speed its
    own.  With seed 0 the order depends on the scene, the view and the plan
    alone.  The dense session keeps its own probe's order."""
    from bevy_raytrace_tpu_torch.kernels.render_lanes import (
        balance_perm,
        render_mxu_with_len,
    )

    probe = config.replace(
        samples_per_pixel=min(PROBE_SPP, config.samples_per_pixel),
        spp_chunk=0, seed=0)
    _, len_map = render_mxu_with_len(scene, camera, probe, 0, plan=plan)
    return balance_perm(len_map).flip(0)


class Renderer:
    """A reusable render session.

    Args:
      config: render configuration.
      backend: "cuda" (the default: the K1 kernel with cost-balanced
        scheduling; needs a CUDA device and raises on any other), "torch"
        (the wavefront, any device), "pallas" (the K2 kernel with the
        cluster-culled traversal; on a CPU scene K2's plain twin), "sharded"
        (the wavefront on this rank's pixel stripe, `shard.render_sharded`)
        or "cuda-sharded" (K1 on this rank's stripe,
        `shard.render_mxu_sharded`: the reference's "mxu-sharded").  The
        sharded backends return the gathered [H, W, 3] image on every rank.
      device: where scenes, cameras and images live; None is the default
        device (`device.default_device()`: the CUDA device, never a silent
        CPU).
      mesh: sharded backends only: the `shard.Mesh`; None is
        `shard.make_mesh()` over the initialized process group.
      cluster_size: "pallas" and "cuda" backends: spheres per cluster of
        the culled traversal (K2's, K1's); 0 disables culling (the
        brute-force loop, the dense sweep).  None, the default, is the
        backend's own: 12 for "pallas", 0 for "cuda", so a "cuda" session
        culls only when asked.  The plan is built from the first scene of
        each (sphere count, cluster_size), only for scenes of at least 32
        spheres, and kept until `replan()`; the clusters' bounds follow the
        live geometry on every frame, so moving spheres need no new plan.
        A culled image is the unculled one bit for bit.  "cuda" builds the
        plan inside the span `k1.plan` and counts it in `k1.plans_built`;
        every launch of the session runs the culled K1
        (`k1.launches_culled`): its probe frame, whose balanced pass and
        every later frame run on the lane order of `culled_perm` (a probe
        of a fixed seed, costliest lanes first) in place of its own
        probe's.  The "pallas" backend renders where the scene lives and
        never moves it.
      replan_interval: "cuda" backend only.  0 keeps the cost-map
        permutation until `replan()`; N > 0 re-probes every N frames, so the
        schedule tracks camera and scene motion.  The image never depends on
        the permutation, only the speed does.
    """

    def __init__(self, config: RenderConfig, backend: str = "cuda",
                 device=None, replan_interval: int = 0, mesh=None,
                 cluster_size=None):
        if cluster_size is None:  # "pallas" culls K2 unless told not to
            cluster_size = 12 if backend == "pallas" else 0
        if cluster_size < 0:
            raise ValueError(f"cluster_size must be >= 0, got {cluster_size}")
        self.config = config
        self.backend = backend
        self.device = resolve(device)
        self.frame = 0
        self.ready = False
        self.replan_interval = replan_interval
        self.cluster_size = cluster_size
        self._warmup_lock = threading.Lock()
        self._warmup_future = None

        if backend == "torch":
            from bevy_raytrace_tpu_torch.wavefront.render import render

            self._step = render
        elif backend == "cuda":
            if self.device.type != "cuda":
                raise ValueError(
                    f'backend="cuda" needs a CUDA device, got {self.device}')
            self._perm = None
            self._perm_pixels = None  # resolution the cached perm is for
            self._frames_on_perm = 0
            self._plans = {}  # (sphere count, cluster_size) -> plan or None
            self._step = self._cuda_step
        elif backend == "pallas":
            self._plans = {}  # (sphere count, cluster_size) -> plan or None
            self._step = self._pallas_step
        elif backend in ("sharded", "cuda-sharded"):
            from bevy_raytrace_tpu_torch.shard import make_mesh
            from bevy_raytrace_tpu_torch.shard.render_sharded import (
                local_pixels,
            )

            self.mesh = make_mesh(device=self.device) if mesh is None else mesh
            local_pixels(config, self.mesh)  # raises on an indivisible frame
            self._step = self._sharded_step
        else:
            raise ValueError(f"unknown backend {backend!r}")

    def _sharded_step(self, scene, camera, config, frame):
        from bevy_raytrace_tpu_torch.shard import (
            render_mxu_sharded,
            render_sharded,
        )

        if self.backend == "sharded":
            return render_sharded(scene, camera, config, self.mesh, frame,
                                  gather=True)
        return render_mxu_sharded(scene, camera, config, self.mesh, frame,
                                  gather=True)

    def _plan(self, scene):
        """The cluster plan for `scene`: None without culling or below
        MIN_CLUSTERED_SPHERES spheres.  Keyed on (count, cluster_size)
        only: membership is static, and a key on the scene's content would
        cost a device-to-host copy of every center on every frame."""
        from bevy_raytrace_tpu_torch.kernels.clusters import cluster_scene

        key = (scene.count, self.cluster_size)
        if key not in self._plans:
            plan = None
            if self.cluster_size and scene.count >= MIN_CLUSTERED_SPHERES:
                if self.backend == "cuda":
                    with span("k1.plan"):
                        plan = cluster_scene(scene, self.cluster_size)
                    count("k1.plans_built")
                else:
                    plan = cluster_scene(scene, self.cluster_size)
            if len(self._plans) >= MAX_PLANS:
                self._plans.pop(next(iter(self._plans)))
            self._plans[key] = plan
        return self._plans[key]

    def _pallas_step(self, scene, camera, config, frame):
        from bevy_raytrace_tpu_torch.kernels.record import render_pallas

        return render_pallas(scene, camera, config, frame,
                             clusters=self._plan(scene))

    def _cuda_step(self, scene, camera, config, frame):
        from bevy_raytrace_tpu_torch.kernels.render_lanes import (
            render_mxu,
            render_probed,
        )

        # A perm is valid only for the resolution it was probed at, and an
        # aged one re-probes when replan_interval is set.
        if self._perm_pixels != config.num_pixels or (
                self.replan_interval > 0
                and self._frames_on_perm >= self.replan_interval):
            self._perm = None
        plan = self._plan(scene) if self.cluster_size else None
        if self._perm is not None:
            self._frames_on_perm += 1
            return render_mxu(scene, camera, config, frame, perm=self._perm,
                              plan=plan)
        if plan is None:
            img, self._perm = render_probed(scene, camera, config, frame,
                                            PROBE_SPP)
        else:
            img, self._perm = render_probed(
                scene, camera, config, frame, PROBE_SPP, plan=plan,
                perm=culled_perm(scene, camera, config, plan))
        self._perm_pixels = config.num_pixels
        self._frames_on_perm = 1
        return img

    def replan(self):
        """Drop cached scheduling state: the "cuda" backend's permutation
        (the next frame re-probes) and cluster plans, and the "pallas"
        backend's cluster plans (the next frame plans from its scene).
        Results never depend on either; after large motion this restores
        speed."""
        if self.backend == "cuda":
            self._perm = None
            self._perm_pixels = None
        if self.backend in ("cuda", "pallas"):
            self._plans.clear()

    def warmup(self, scene, camera):
        """Render frame 0 once (builds the kernel on first use); returns the
        seconds it took.  The frame counter does not advance."""
        t0 = time.perf_counter()
        synchronize(self._step(scene, camera, self.config, 0))
        self.ready = True
        return time.perf_counter() - t0

    def warmup_async(self, scene, camera):
        """`warmup` on a daemon thread -> a Future of its seconds.  A call
        while one is pending returns the pending future."""
        with self._warmup_lock:
            pending = self._warmup_future
            if pending is not None and not pending.done():
                return pending
            fut = concurrent.futures.Future()
            self._warmup_future = fut

        def run():
            try:
                fut.set_result(self.warmup(scene, camera))
            except Exception as e:  # noqa: BLE001 — routed to the future
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True, name="brt-warmup").start()
        return fut

    def render_frame(self, scene, camera):
        """Render the next frame (the frame counter auto-advances).  Its
        host side, from the request to the last enqueue, is the span
        `session.frame`, which marks the spans inside it with the frame."""
        with span("session.frame", frame=self.frame):
            img = self._step(scene, camera, self.config, self.frame)
        self.frame += 1
        self.ready = True
        return img
