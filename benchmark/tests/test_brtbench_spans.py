"""The readers of the port's spans, by hand on built records, and the
clock the spans share with the runner's marks, on a traced CPU run of the
real-time cell through the port's plain paths."""

import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from brtbench import spec, tracing
from brtbench.spans import per_frame_ms
from bevy_raytrace_tpu_torch.utils import spans
from bevy_raytrace_tpu_torch.utils.spans import SpanRecord
from twin_session import TwinSession, no_sync, tiny_cell

CELL = "bevy_reference.realtime"
SPAN_METRICS = ["camera_ms.realtime", "session_self_ms.realtime",
                "tables_ms.realtime", "launch_ms.realtime",
                "scatter_ms.realtime"]


def _run(trace=True):
    """Two frames' marks, window [100, 450] ns."""
    marks = np.array([[100, 110, 200, 250], [260, 270, 400, 450]])
    return types.SimpleNamespace(trace=object() if trace else None,
                                 marks=marks, frames=2)


def test_readers_hand_worked(monkeypatch):
    recs = [SpanRecord("session.frame", 110, 200, None, 0),
            SpanRecord("k1.tables", 120, 140, 0, 0),
            SpanRecord("k1.launch", 130, 160, 0, 0),  # overlaps the tables
            SpanRecord("k1.scatter", 170, 180, 0, 0),
            SpanRecord("inner", 175, 178, 3, 0),  # not a direct child
            SpanRecord("session.frame", 270, 400, None, 1),
            SpanRecord("k1.launch", 300, 350, 5, 1),
            SpanRecord("session.frame", 460, 500, None, 2),  # after
            SpanRecord("session.frame", 50, 90, None, None)]  # before
    run = _run()
    monkeypatch.setattr(spans, "spans", lambda: recs)
    ms = 1e-6 / 2  # ns summed -> ms a frame
    assert per_frame_ms(run, "session.frame") == pytest.approx(220 * ms)
    # 90 - |[120, 160] u [170, 180]| = 40, and 130 - 50 = 80.
    assert per_frame_ms(run, "session.frame",
                        self_time=True) == pytest.approx(120 * ms)
    assert per_frame_ms(run, "k1.launch") == pytest.approx(80 * ms)
    assert per_frame_ms(run, "k1.scatter",
                        self_time=True) == pytest.approx(7 * ms)
    assert per_frame_ms(run, "camera.look_at") is None
    assert per_frame_ms(_run(trace=False), "k1.launch") is None
    for name in SPAN_METRICS:
        value = spec.reader(name)(run)
        if name == "camera_ms.realtime":
            assert value is None
        else:
            assert value > 0


def test_spans_share_the_clock_of_the_runners_marks(monkeypatch):
    """The real session runner, traced, on the real-time cell at a CPU
    size: every frame's K1 spans lie inside that frame's `render_frame`
    step, and its camera span inside its `camera` step."""
    runner = spec.runner("session")
    monkeypatch.setattr(runner, "profiler", lambda: profile(
        activities=[ProfilerActivity.CPU]))
    monkeypatch.setattr(runner, "launch_marker",
                        lambda device: time.perf_counter_ns())
    monkeypatch.setattr(runner, "reduce", lambda prof, marker_ns, marks,
                        steps: tracing.Trace(1.0, 0.0, {}, {}))
    spans.clear_spans()
    try:
        rec = runner.run(tiny_cell(CELL, frames=1, pixels=32), 2**31 + 7,
                         0.2, True, torch.device("cpu"), time.perf_counter(),
                         make_session=TwinSession, sync=no_sync)
        recs = spans.spans()
        values = {name: spec.reader(name)(rec) for name in SPAN_METRICS}
    finally:
        spans.clear_spans()
    assert runner.STEPS == ("camera", "render_frame", "synchronize")
    marks = np.asarray(rec.marks)
    assert rec.frames == marks.shape[0] >= 2
    frame_of = {}
    for r in recs:
        k = int(np.searchsorted(marks[:, 0], r.t0_ns, side="right")) - 1
        assert 0 <= k and r.t1_ns <= marks[k, 3], r
        frame_of.setdefault(k, []).append(r)
    assert sorted(frame_of) == list(range(marks.shape[0]))
    for k, rs in frame_of.items():
        cams = [r for r in rs if r.name == "camera.look_at"]
        k1 = [r for r in rs if r.name.startswith("k1.")]
        assert [r.name for r in k1] == ["k1.tables", "k1.launch",
                                        "k1.scatter"]
        assert len(cams) == 1 and len(rs) == 4
        assert marks[k, 0] <= cams[0].t0_ns <= cams[0].t1_ns <= marks[k, 1]
        for r in k1:
            assert marks[k, 1] <= r.t0_ns <= r.t1_ns <= marks[k, 2]
    # The CPU session opens no frame span: no session self time.
    assert values.pop("session_self_ms.realtime") is None
    assert all(v > 0 for v in values.values()), values
