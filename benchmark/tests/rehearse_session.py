"""The `session` runner's CPU rehearsal (see brtbench/main.py).

A session of the port's plain paths for the CPU: `Renderer("cuda")`'s
frame schedule (a probe frame, then the cached cost-balanced permutation)
through `render_probed` and `render_mxu` on CPU tensors, which run K1's
plain twin.  The card's session refuses the CPU."""

import dataclasses
import time

from brtbench import spec, tracing, traffic

# The block fault's band is a twentieth of the rows (two of 24, 8%): it
# shows on every pixel of the tiny frame, not on a sample of 96.
FAULT_PIXELS = {"block": 32 * 24}


class TwinSession:
    PROBE_SPP = 16

    def __init__(self, config, device):
        self.config = config
        self.frame = 0
        self._perm = None

    def render_frame(self, scene, camera):
        from bevy_raytrace_tpu_torch.kernels.render_lanes import (
            render_mxu,
            render_probed,
        )

        if self._perm is None:
            img, self._perm = render_probed(scene, camera, self.config,
                                            self.frame, self.PROBE_SPP)
        else:
            img = render_mxu(scene, camera, self.config, self.frame,
                             perm=self._perm)
        self.frame += 1
        return img


make_session = TwinSession


def sync():
    return None


def tiny_cell(name, fault=None, width=32, height=24, frames=2, pixels=None):
    """The cell `name` of BENCHMARK.json at a size the CPU holds: 32 x 24,
    at most 4 samples a pixel (256 are too many for a CPU test; 4 keep the
    shape), `pixels` checked pixels of `frames` frames (96, or as many as
    `fault` needs to show)."""
    cell = spec.load_cell(name)
    config = dict(cell.config, width=width, height=height)
    mix = dict(cell.traffic)
    if traffic.samples_per_pixel(mix, config) > 4:
        mix["samples_per_pixel"] = 4
    if pixels is None:
        pixels = FAULT_PIXELS.get(fault, 96)
    check = dict(cell.check, frames=frames, pixels=pixels)
    return dataclasses.replace(cell, config=config, traffic=mix, check=check)


def trace(monkeypatch, runner):
    """A traced run on the CPU: the profiler of the host's activity, the
    marker at the window's start, and a trace of the window with no device
    activity (the CPU has no card to trace)."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(runner, "profiler", lambda: profile(
        activities=[ProfilerActivity.CPU]))
    monkeypatch.setattr(runner, "launch_marker",
                        lambda device: time.perf_counter_ns())
    monkeypatch.setattr(runner, "reduce", lambda prof, marker_ns, marks,
                        steps: tracing.Trace(
                            (marks[-1, -1] - marks[0, 0]) * 1e-9, 0.0, {},
                            {}))
