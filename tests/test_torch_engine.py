"""The port's Renderer session: backends, frame counter, replan, warmup."""

import numpy as np
import pytest
import torch

from bevy_raytrace_tpu_torch import RenderConfig
from bevy_raytrace_tpu_torch import set_default_device
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch.wavefront.engine import Renderer
from bevy_raytrace_tpu_torch.wavefront.render import render

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

CFG = RenderConfig(width=32, height=16, samples_per_pixel=2, max_depth=3)


def _scene():
    scene, _ = tsc.baseline_config2_scene()
    return scene, tsc.baseline_config2_camera(CFG.aspect)


def test_torch_backend_frame_counter_and_replan():
    scene, cam = _scene()
    r = Renderer(CFG, backend="torch")
    assert not r.ready
    f0 = r.render_frame(scene, cam)
    f1 = r.render_frame(scene, cam)
    assert r.frame == 2 and r.ready
    np.testing.assert_array_equal(f0.numpy(), render(scene, cam, CFG, 0).numpy())
    np.testing.assert_array_equal(f1.numpy(), render(scene, cam, CFG, 1).numpy())
    r.replan()  # nothing cached: a no-op that keeps the session usable
    f2 = r.render_frame(scene, cam)
    np.testing.assert_array_equal(f2.numpy(), render(scene, cam, CFG, 2).numpy())
    assert r.frame == 3


def test_warmup_and_warmup_async():
    scene, cam = _scene()
    r = Renderer(CFG, backend="torch")
    assert r.warmup(scene, cam) > 0 and r.ready and r.frame == 0
    fut = r.warmup_async(scene, cam)
    assert fut.result(timeout=60) > 0


def test_cuda_backend_needs_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA device"):
        Renderer(CFG, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        Renderer(CFG, backend="mxu")


@pytest.fixture
def cuda_session(monkeypatch):
    """Renderer(backend="cuda") past its device check: its session (the
    probe frame, the cached perm, replan_interval) then renders CPU scenes
    through K1's twin, where the reference's tests run the TPU kernel in
    interpret mode (tests/test_engine.py, the test_renderer_mxu_* four)."""
    from bevy_raytrace_tpu_torch.wavefront import engine

    monkeypatch.setattr(engine, "resolve", lambda device: torch.device("cuda"))
    return lambda cfg, **kw: Renderer(cfg, backend="cuda", **kw)


def test_cuda_session_temporal_perm_reuse(cuda_session):
    """Frame 0 caches the cost-map permutation; frame 1 renders on it and
    is bit for bit the plain K1 render of frame 1; replan() drops it."""
    from bevy_raytrace_tpu_torch.kernels.render_lanes import render_mxu

    scene, cam = _scene()
    r = cuda_session(CFG)
    r.render_frame(scene, cam)
    assert r._perm is not None
    img1 = r.render_frame(scene, cam)
    assert torch.equal(img1, render_mxu(scene, cam, CFG, 1))
    r.replan()
    assert r._perm is None


def test_cuda_session_frame0_rest_pass(cuda_session):
    """spp above the probe's: frame 0 is the probe plus the rest pass
    (sample_base), bit for bit the balanced render of frame 0."""
    from bevy_raytrace_tpu_torch.kernels.render_lanes import (
        render_mxu_balanced,
    )

    cfg = CFG.replace(samples_per_pixel=32)
    scene, cam = _scene()
    img0 = cuda_session(cfg).render_frame(scene, cam)
    assert torch.equal(img0, render_mxu_balanced(scene, cam, cfg, 0))


def test_cuda_session_auto_replan_interval(cuda_session):
    """replan_interval=2 re-probes every 2 frames: probe frames allclose to
    the plain render (the probe's samples are summed apart), cached frames
    bit for bit, and the perm replaced on schedule."""
    from bevy_raytrace_tpu_torch.kernels.render_lanes import render_mxu

    cfg = CFG.replace(samples_per_pixel=20)  # probe 16 + a rest pass
    scene, cam = _scene()
    r = cuda_session(cfg, replan_interval=2)
    perms = []
    for i in range(4):
        img = r.render_frame(scene, cam)
        want = render_mxu(scene, cam, cfg, i)
        if i % 2 == 0:  # probe frames
            np.testing.assert_allclose(img.numpy(), want.numpy(), atol=2e-4)
        else:
            assert torch.equal(img, want)
        perms.append(r._perm)
    assert perms[0] is perms[1] and perms[2] is perms[3]
    assert perms[2] is not perms[0]


def test_cuda_session_replan_interval_off_by_default(cuda_session):
    scene, cam = _scene()
    r = cuda_session(CFG)
    r.render_frame(scene, cam)
    perm0 = r._perm
    for _ in range(3):
        r.render_frame(scene, cam)
    assert r._perm is perm0 and r.replan_interval == 0


def test_pallas_backend_plans_by_count_and_cluster_size():
    """Renderer(backend="pallas"): the cluster plan is built from the first
    scene of each (sphere count, cluster_size), only for scenes of at least
    32 spheres, kept across frames and moved spheres, dropped by
    replan(); every frame is K2's (its twin's, on the CPU) image."""
    import dataclasses

    from bevy_raytrace_tpu_torch.kernels.record import render_pallas

    big, _ = tsc.rtiow_final_scene(seed=3, grid=3)  # 37 spheres
    cam = tsc.rtiow_final_camera(CFG.aspect)
    assert big.count >= 32
    r = Renderer(CFG, backend="pallas", device="cpu", cluster_size=6)
    f0 = r.render_frame(big, cam)
    plan = r._plans[(big.count, 6)]
    assert plan is not None and plan.cluster_size == 6
    moved = dataclasses.replace(big, centers=big.centers + 0.25)
    f1 = r.render_frame(moved, cam)
    assert r._plans[(big.count, 6)] is plan and len(r._plans) == 1
    np.testing.assert_array_equal(
        f0.numpy(), render_pallas(big, cam, CFG, 0).numpy())
    np.testing.assert_array_equal(
        f1.numpy(), render_pallas(moved, cam, CFG, 1).numpy())
    assert r.frame == 2

    small, small_cam = _scene()  # 5 spheres: below the threshold, no plan
    r.render_frame(small, small_cam)
    assert r._plans[(small.count, 6)] is None and len(r._plans) == 2
    r.cluster_size = 12  # another key: a second plan for the same count
    r.render_frame(big, cam)
    assert r._plans[(big.count, 12)].cluster_size == 12 and len(r._plans) == 3
    r.replan()
    assert r._plans == {}
    r.render_frame(big, cam)
    assert r._plans[(big.count, 12)] is not plan

    off = Renderer(CFG, backend="pallas", device="cpu", cluster_size=0)
    off.render_frame(big, cam)
    assert off._plans == {(big.count, 0): None}
    with pytest.raises(ValueError, match="cluster_size"):
        Renderer(CFG, backend="pallas", device="cpu", cluster_size=-1)


def test_pallas_backend_keeps_a_bounded_plan_cache():
    from bevy_raytrace_tpu_torch.wavefront.engine import MAX_PLANS

    scene, cam = _scene()
    r = Renderer(CFG, backend="pallas", device="cpu")
    for size in range(1, MAX_PLANS + 3):
        r.cluster_size = size
        r.render_frame(scene, cam)
    assert len(r._plans) == MAX_PLANS
    assert (scene.count, 1) not in r._plans  # the oldest went first


def test_trace_profile_writes_a_trace(tmp_path):
    import json

    from bevy_raytrace_tpu_torch.utils import spans
    from bevy_raytrace_tpu_torch.utils.metrics import trace_profile

    scene, cam = _scene()
    with trace_profile(str(tmp_path / "trace")) as prof:
        Renderer(CFG, backend="torch").render_frame(scene, cam)
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert len(prof.key_averages()) > 0
    # The session's frame span, written out and then cleared.
    with open(tmp_path / "trace" / "spans.json") as f:
        out = json.load(f)
    assert [(r["name"], r["parent"], r["frame"]) for r in out["spans"]] == [
        ("session.frame", None, 0)]
    assert 0 < out["spans"][0]["t0_ns"] < out["spans"][0]["t1_ns"]
    assert isinstance(out["counters"], dict)
    assert spans.spans() == []
