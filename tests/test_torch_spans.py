"""The port's recorder (`utils/spans.py`): spans only while a profiler runs,
nested by thread and marked with their session frame; counters always."""

import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bevy_raytrace_tpu_torch import Camera, RenderConfig
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch import set_default_device
from bevy_raytrace_tpu_torch.kernels.render_lanes import (
    render_mxu,
    render_probed,
)
from bevy_raytrace_tpu_torch.utils import spans
from bevy_raytrace_tpu_torch.wavefront.engine import Renderer

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

CFG = RenderConfig(width=32, height=16, samples_per_pixel=2, max_depth=3)
K1_SPANS = ["k1.tables", "k1.launch", "k1.scatter"]


@pytest.fixture
def recorded():
    """Spans cleared before the test and after it."""
    spans.clear_spans()
    yield
    spans.clear_spans()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def test_no_profiler_no_span_and_counters_count(recorded):
    assert not torch.autograd.profiler._is_profiler_enabled
    with spans.span("outer", frame=1):
        with spans.span("inner"):
            pass
    assert spans.spans() == []
    spans.reset_counters("test.")
    spans.count("test.a")
    spans.count("test.a", 2)
    spans.count("test.b")
    assert spans.counter("test.a") == 3 and spans.counter("test.none") == 0
    assert spans.counters("test.") == {"test.a": 3, "test.b": 1}
    spans.reset_counters("test.a")
    assert spans.counters("test.") == {"test.b": 1}
    spans.reset_counters("test.")
    assert spans.counters("test.") == {}


def test_counts_from_many_threads_are_not_lost():
    """16 threads, each 2,000 counts, with the interpreter switching
    threads as often as it can: every count arrives."""
    spans.reset_counters("stress.")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            spans.count("stress.n") for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert spans.counter("stress.n") == 16 * 2000
    spans.reset_counters("stress.")


def test_session_frame_and_camera_spans(recorded):
    scene, _ = tsc.baseline_config2_scene()
    r = Renderer(CFG, backend="torch")
    r.render_frame(scene, tsc.baseline_config2_camera(CFG.aspect))
    with _profiled():
        cam = Camera.look_at((0.0, 1.0, 4.0), (0.0, 0.0, 0.0),
                             aspect=CFG.aspect)
        r.render_frame(scene, cam)
    recs = spans.spans()
    assert [(s.name, s.parent, s.frame) for s in recs] == [
        ("camera.look_at", None, None), ("session.frame", None, 1)]
    assert recs[0].t1_ns <= recs[1].t0_ns
    assert all(s.t0_ns < s.t1_ns for s in recs)


def test_k1_spans_nest_under_the_enclosing_span(recorded):
    """A probe frame's two K1 passes and a cached frame's one: each pass
    its tables, launch (the twin here) and scatter, in turn, inside the
    enclosing span, with its index as their parent and its frame."""
    scene, _ = tsc.baseline_config2_scene()
    cam = tsc.baseline_config2_camera(CFG.aspect)
    with _profiled():
        with spans.span("outer", frame=7):
            _, perm = render_probed(scene, cam, CFG, 0, probe_spp=1)
            render_mxu(scene, cam, CFG, 1, perm=perm)
    recs = spans.spans()
    assert [s.name for s in recs] == ["outer"] + K1_SPANS * 3
    assert (recs[0].parent, recs[0].frame) == (None, 7)
    assert all((s.parent, s.frame) == (0, 7) for s in recs[1:])
    for a, b in zip(recs[1:], recs[2:]):
        assert a.t1_ns <= b.t0_ns
    assert recs[0].t0_ns <= recs[1].t0_ns and recs[-1].t1_ns <= recs[0].t1_ns


def test_a_span_on_another_thread_takes_no_main_thread_parent(recorded):
    def work():
        with spans.span("worker"):
            with spans.span("worker.inner"):
                pass

    with _profiled():
        with spans.span("main", frame=3):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
            with spans.span("main.inner"):
                pass
    assert not t.is_alive()
    recs = {s.name: (i, s) for i, s in enumerate(spans.spans())}
    assert set(recs) == {"main", "worker", "worker.inner", "main.inner"}
    main_i, main = recs["main"]
    worker_i, worker = recs["worker"]
    assert (main.parent, main.frame) == (None, 3)
    assert (worker.parent, worker.frame) == (None, None)
    assert recs["worker.inner"][1].parent == worker_i
    assert (recs["main.inner"][1].parent,
            recs["main.inner"][1].frame) == (main_i, 3)


def test_a_span_costs_little_with_no_profiler(recorded):
    """With no profiler a span is a flag read: 0.3-0.7 us on a lightly
    loaded CPU, and well under 5 us on a loaded one."""
    n = 20000
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with spans.span("k1.launch"):
                pass
        best = min(best, (time.perf_counter() - t0) / n)
    assert spans.spans() == []
    assert best < 5e-6, f"{best * 1e6:.3f} us a span"
