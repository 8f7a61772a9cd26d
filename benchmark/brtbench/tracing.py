"""The traced run: the card's activity over the measured window, from
`torch.profiler`, and its reduction to device busy time, device time by
kernel and the idle gaps by what the host was doing.

The profiler records CUDA activity only (kernels, copies, fills, from
CUPTI's buffers): recording every host-side PyTorch operation as well costs
~15 us an operation, which nearly doubled the real-time cell's frames and
would have measured the tracer.  What the host was doing comes from the
harness's own clock instead: the runner stamps the host steps of each
item of work (the `STEPS` that its module names: for a frame, its camera,
the session's `render_frame`, the wait for the device), and a marker fill
launched at a stamped instant before the window maps the host's clock onto
the trace's.  The mapping is late by the marker's launch latency
(some microseconds), which only moves a gap's label where the gap lies
within that of a step's edge.  No span inside the program is recorded yet.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

_DEVICE_ACTIVITIES = {"kernel", "gpu_memcpy", "gpu_memset"}


def profiler():
    """The profiler a traced window runs under (CUDA activity only)."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def launch_marker(device) -> int:
    """Launch one fill on the idle device and return the host clock
    (perf_counter ns) at the launch; waits for it."""
    import torch

    torch.cuda.synchronize(device)
    t = time.perf_counter_ns()
    torch.ones(1, device=device)
    torch.cuda.synchronize(device)
    return t


@dataclasses.dataclass
class Trace:
    """A traced window, reduced.  Times in seconds."""

    window_s: float
    busy_s: float
    kernels: dict  # device op name -> (seconds, count)
    idle_by_step: dict  # host step (or "harness") -> idle seconds

    def kernel_seconds(self, fragment: str):
        """(seconds, launches) of the device ops whose name holds
        `fragment`; (0.0, 0) if none ran."""
        s = c = 0
        for name, (sec, n) in self.kernels.items():
            if fragment in name:
                s, c = s + sec, c + n
        return s, c

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.idle_by_step.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:120], v[0]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _device_events(prof):
    """(name, start_ns, end_ns) of every kernel, copy and fill traced.  A
    CUDA-only trace holds no other device events; where the profiler's
    events also name their activity (newer PyTorch), it is checked too."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if (hasattr(e, "activity_type")
                and str(e.activity_type()) not in _DEVICE_ACTIVITIES):
            continue
        out.append((e.name(), e.start_ns(), e.end_ns()))
    return out


def _union(starts, ends):
    """Merge intervals -> (starts, ends) of the disjoint union, sorted."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(s.shape, bool)
    new[1:] = s[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.maximum.reduceat(e, idx)


def reduce(prof, marker_ns: int, marks, steps) -> Trace:
    """Reduce the trace of a window.

    marker_ns: `launch_marker`'s host instant; the first device event of
    the trace is that fill.  steps: the names of the host steps of one
    item of work (a frame, an optimizer step), in order.  marks: int64
    [n, len(steps) + 1] host perf_counter ns: when each step of each item
    began, and when its last step ended; the window runs from the first
    item's first mark to the last item's last."""
    marks = np.asarray(marks, np.int64)
    width = len(steps) + 1
    if marks.ndim != 2 or marks.shape[1] != width:
        raise ValueError(f"marks of shape {marks.shape} for {len(steps)} "
                         "steps")
    events = sorted(_device_events(prof), key=lambda t: t[1])
    if not events:
        raise RuntimeError("the trace holds no device activity")
    offset = events[0][1] - marker_ns  # trace ns - host ns
    w0, w1 = int(marks[0, 0]) + offset, int(marks[-1, -1]) + offset
    kernels = {}
    starts, ends = [], []
    for name, s, e in events[1:]:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        sec, cnt = kernels.get(name, (0.0, 0))
        kernels[name] = (sec + (e - s) * 1e-9, cnt + 1)
        starts.append(s)
        ends.append(e)
    if starts:
        us, ue = _union(np.array(starts, np.int64), np.array(ends, np.int64))
        busy = float((ue - us).sum()) * 1e-9
        g0, g1 = np.concatenate([[w0], ue]), np.concatenate([us, [w1]])
    else:
        busy, g0, g1 = 0.0, np.array([w0]), np.array([w1])
    keep = g1 > g0
    g0, g1 = g0[keep] - offset, g1[keep] - offset  # back on the host clock
    # Each gap's middle falls in one item's step, or between items.
    mid = (g0 + g1) // 2
    flat = marks.reshape(-1)
    pos = np.searchsorted(flat, mid, side="right") - 1
    names = np.array(list(steps) + ["harness"], object)
    n = len(steps)
    step = np.where((pos >= 0) & (pos % width < n), pos % width, n)
    idle = {}
    for label, gs in zip(names[step], (g1 - g0) * 1e-9):
        idle[label] = idle.get(label, 0.0) + float(gs)
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy, kernels=kernels,
                 idle_by_step=idle)
