"""The frozen counts against hand-worked cases, and the roofline reader."""

import types

import pytest

from brtbench import spec
from brtbench.yardstick import forward_sweep, peaks


def test_bound_picks_the_larger_time():
    assert peaks.bound_seconds(67e12, 0) == (1.0, "operations")
    assert peaks.bound_seconds(0, 3.35e12) == (1.0, "bytes")
    assert peaks.bound_seconds(67e12, 2 * 3.35e12) == (2.0, "bytes")


@pytest.mark.parametrize("kernel,res,flops,nbytes", [
    # 5 rounds x (10 spheres x 16 + 120) + 2 pixels x 3 samples x 70;
    # tables 10 x 48 + camera 64 + image 2 x 12, then K1's 2 x 8 pids+len.
    ("k1", 0, 5 * 280 + 420, 480 + 64 + 24 + 16),
    # K2 counted brute force: no pids, two int16 residual streams
    # (2 x 2 bytes x 3 samples x 4 bounces x 2 pixels).
    ("k2", 2, 5 * 280 + 420, 480 + 64 + 24 + 96),
])
def test_forward_work_hand_worked(kernel, res, flops, nbytes):
    assert forward_sweep.forward_work(kernel, 10, 2, 3, 4, 5, res) == (
        flops, nbytes)


def test_forward_bound_is_operations_at_real_sizes():
    # The flagship frame: 960,000 pixels x 256 samples, ~3 rounds a path.
    sec, by = forward_sweep.forward_bound("k1", 488, 960_000, 256, 8,
                                          3 * 960_000 * 256)
    assert by == "operations"
    assert sec == pytest.approx(3 * 245_760_000 * (488 * 16 + 120) / 67e12
                                + 245_760_000 * 70 / 67e12)


def _record(k1_seconds, launches, busy=1.0, window=2.0):
    trace = types.SimpleNamespace(
        window_s=window, busy_s=busy,
        kernel_seconds=lambda frag: ((k1_seconds, launches)
                                     if frag == "k1_render_kernel"
                                     else (0.0, 0)))
    return types.SimpleNamespace(trace=trace, rounds_per_path=2.5,
                                 paths_per_frame=100 * 4, n_spheres=10,
                                 n_pix=100, spp=4, depth=8)


def test_k1_roofline_reader_hand_worked():
    rec = _record(k1_seconds=1e-9, launches=3)
    flops = 2.5 * 400 * (10 * 16 + 120) + 400 * 70
    nbytes = 10 * 48 + 64 + 100 * 12 + 100 * 8
    least = max(flops / 67e12, nbytes / 3.35e12)
    for name in ("k1_roofline_pct", "k1_roofline_pct.realtime"):
        assert spec.reader(name)(rec) == pytest.approx(100 * least * 3 / 1e-9)


def test_readers_find_nothing_without_a_trace_or_a_launch():
    assert spec.reader("k1_roofline_pct")(_record(0.0, 0)) is None
    rec = _record(1.0, 1)
    rec.trace = None
    for name in ("k1_roofline_pct", "k1_roofline_pct.realtime",
                 "device_idle_pct.render", "device_idle_pct.realtime"):
        assert spec.reader(name)(rec) is None


def test_idle_reader():
    rec = _record(1.0, 1, busy=1.5, window=2.0)
    for name in ("device_idle_pct.render", "device_idle_pct.realtime"):
        assert spec.reader(name)(rec) == pytest.approx(25.0)


def test_end_to_end_readers_hand_worked():
    rec = types.SimpleNamespace(frames=4, paths_per_frame=1000, window_s=2.0,
                                setup_s=7.5)
    assert spec.reader("rays_per_s")(rec) == 2000.0
    assert spec.reader("rays_per_s.realtime")(rec) == 2000.0
    assert spec.reader("setup_s")(rec) == 7.5


def test_frame_tail_reader_hand_worked():
    rec = types.SimpleNamespace(latencies_s=[i * 1e-3 for i in range(1, 21)])
    # numpy's linear percentile of 1..20 ms: 19 + 0.05 = 19.05 ms.
    assert spec.reader("frame_ms_p95.session")(rec) == pytest.approx(19.05)
