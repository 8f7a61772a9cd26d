"""The port's own spans, read per frame of a traced window.

The port records a span (`bevy_raytrace_tpu_torch/utils/spans.py`) only
while a profiler runs, as it does over a traced run's window, and stamps it
with `time.perf_counter_ns`: the clock of the runner's marks, so a span is
placed against the marks, and on the device trace, as the marks are.  A run
with no trace, or a program without that recorder, has nothing to read.
"""

from __future__ import annotations


def _covered(t0: int, t1: int, intervals) -> int:
    """ns of [t0, t1] that the union of `intervals` covers."""
    out, reach = 0, t0
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, t1)
        if e > s:
            out += e - s
            reach = e
    return out


def per_frame_ms(run, name: str, self_time: bool = False):
    """Milliseconds a frame of the window spent in the port's spans called
    `name`: their summed durations, each less the union of its direct
    children's intervals with `self_time`, over the run's frames.  Only the
    spans inside [first mark, last mark] count.  None without a trace, or
    where no span of that name was recorded in the window."""
    if run.trace is None:
        return None
    try:
        from bevy_raytrace_tpu_torch.utils.spans import spans
    except ImportError:
        return None
    recs = spans()
    lo, hi = int(run.marks[0][0]), int(run.marks[-1][-1])
    children = {}
    if self_time:
        for r in recs:
            if r.parent is not None and r.t1_ns is not None:
                children.setdefault(r.parent, []).append((r.t0_ns, r.t1_ns))
    total, found = 0, False
    for i, r in enumerate(recs):
        if (r.name != name or r.t1_ns is None or r.t0_ns < lo
                or r.t1_ns > hi):
            continue
        found = True
        total += r.t1_ns - r.t0_ns
        if self_time:
            total -= _covered(r.t0_ns, r.t1_ns, children.get(i, ()))
    if not found:
        return None
    return total * 1e-6 / run.frames
