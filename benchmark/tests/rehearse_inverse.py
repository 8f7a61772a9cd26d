"""The `inverse` runner's CPU rehearsal (see brtbench/main.py).

The runner's own session on CPU tensors: the port's inverse path as on the
card, where `make_fast_renderer`'s recorder and replay run K2's and K3's
plain twins (K2's twin sweeps the cluster plan's members in Morton order
with no bound test)."""

import dataclasses
import time

from brtbench import spec, tracing

# The frame's size and samples on the CPU; the faults that the tiny frame
# shows only on more pixels check every pixel of it.
WIDTH, HEIGHT, SPP = 32, 24, 4
FAULT_PIXELS = {"no_edge": WIDTH * HEIGHT}


def make_session(problem, device):
    return spec.runner("inverse").default_session(problem, device)


def sync():
    return None


def tiny_cell(name, fault=None, steps=2, pixels=None):
    """The cell `name` of BENCHMARK.json at a size the CPU holds: 32 x 24,
    4 samples a pixel (64 are too many for a CPU test; 4 keep the shape and
    halve), `pixels` checked pixels of `steps` kept steps (96, or as many
    as `fault` needs to show)."""
    cell = spec.load_cell(name)
    config = dict(cell.config, width=WIDTH, height=HEIGHT)
    mix = dict(cell.traffic, samples_per_pixel=SPP)
    if pixels is None:
        pixels = FAULT_PIXELS.get(fault, 96)
    check = dict(cell.check, steps=steps, pixels=pixels)
    return dataclasses.replace(cell, config=config, traffic=mix, check=check)


def trace(monkeypatch, runner):
    """A traced run on the CPU: the profiler of the host's activity (the
    port's spans record under it), the marker at the window's start, and a
    trace of the window with no device activity."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(runner, "profiler", lambda: profile(
        activities=[ProfilerActivity.CPU]))
    monkeypatch.setattr(runner, "launch_marker",
                        lambda device: time.perf_counter_ns())
    monkeypatch.setattr(runner, "reduce", lambda prof, marker_ns, marks,
                        steps: tracing.Trace(
                            (marks[-1, -1] - marks[0, 0]) * 1e-9, 0.0, {},
                            {}))
