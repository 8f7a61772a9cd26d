"""The `session_culled` runner's CPU rehearsal (see brtbench/main.py).

A session of the port's plain paths for the CPU: `Renderer("cuda",
cluster_size=L)`'s frame schedule (the plan built once from the first
scene, a probe frame, then the cached lane order of `engine.culled_perm`,
a probe of a fixed seed reversed, costliest lanes first), with the plan,
through `render_probed` and `render_mxu` on CPU tensors, which run K1's
culled twin.  The card's
session refuses the CPU.  The tiny cell shrinks the sphereflake to level
2 (91 spheres and the ground)."""

import dataclasses
import time

from brtbench import spec, tracing, traffic

# Faults shown on every pixel of the tiny frame: the block fault's band is a
# twentieth of the rows (two of 24), and the chunks drop_chunks leaves out
# cover a part of it only.
FAULT_PIXELS = {"block": 32 * 24, "drop_chunks": 32 * 24}
TINY_FLAKE_LEVEL = 2
CLUSTER_SIZE = spec.runner("session_culled").CLUSTER_SIZE


class CulledTwinSession:
    PROBE_SPP = 16
    MIN_CLUSTERED_SPHERES = 32

    def __init__(self, config, device):
        self.config = config
        self.frame = 0
        self._perm = None
        self._plan = None
        self.cluster_size = CLUSTER_SIZE

    def render_frame(self, scene, camera):
        from bevy_raytrace_tpu_torch.kernels.clusters import cluster_scene
        from bevy_raytrace_tpu_torch.kernels.render_lanes import (
            render_mxu,
            render_probed,
        )
        from bevy_raytrace_tpu_torch.wavefront.engine import culled_perm

        if self._plan is None and scene.count >= self.MIN_CLUSTERED_SPHERES:
            self._plan = cluster_scene(scene, self.cluster_size)
        if self._perm is None:
            perm = (None if self._plan is None else
                    culled_perm(scene, camera, self.config, self._plan))
            img, self._perm = render_probed(scene, camera, self.config,
                                            self.frame, self.PROBE_SPP,
                                            plan=self._plan, perm=perm)
        else:
            img = render_mxu(scene, camera, self.config, self.frame,
                             perm=self._perm, plan=self._plan)
        self.frame += 1
        return img


make_session = CulledTwinSession


def sync():
    return None


def tiny_cell(name, fault=None, width=32, height=24, frames=2, pixels=None):
    """The cell `name` of BENCHMARK.json at a size the CPU holds: 32 x 24,
    at most 4 samples a pixel, a sphereflake of level 2, `pixels` checked
    pixels of `frames` frames (96, or as many as `fault` needs to show)."""
    cell = spec.load_cell(name)
    config = dict(cell.config, width=width, height=height)
    if "flake" in config["scene"]:
        scene = dict(config["scene"])
        scene["flake"] = dict(scene["flake"], level=TINY_FLAKE_LEVEL)
        config["scene"] = scene
    mix = dict(cell.traffic)
    if traffic.samples_per_pixel(mix, config) > 4:
        mix["samples_per_pixel"] = 4
    if pixels is None:
        pixels = FAULT_PIXELS.get(fault, 96)
    check = dict(cell.check, frames=frames, pixels=pixels)
    return dataclasses.replace(cell, config=config, traffic=mix, check=check)


def trace(monkeypatch, runner):
    """A traced run on the CPU: the `session` runner's window (which this
    runner drives) under the profiler of the host's activity, the marker
    at the window's start, and a trace of the window with no device
    activity (the CPU has no card to trace)."""
    from torch.profiler import ProfilerActivity, profile

    inner = runner._session
    monkeypatch.setattr(inner, "profiler", lambda: profile(
        activities=[ProfilerActivity.CPU]))
    monkeypatch.setattr(inner, "launch_marker",
                        lambda device: time.perf_counter_ns())
    monkeypatch.setattr(inner, "reduce", lambda prof, marker_ns, marks,
                        steps: tracing.Trace(
                            (marks[-1, -1] - marks[0, 0]) * 1e-9, 0.0, {},
                            {}))
