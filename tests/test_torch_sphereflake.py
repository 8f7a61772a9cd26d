"""The SPD sphereflake (`scenes.sphereflake_scene`) against the benchmark's
own generator, the culled K1 twin on it, and the "cuda" session's cluster
plans (on the CPU: the session's schedule runs K1's twins)."""

import json
import sys
import types
from pathlib import Path

import pytest
import torch

from bevy_raytrace_tpu_torch import RenderConfig
from bevy_raytrace_tpu_torch import set_default_device
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch.kernels import render_lanes as k1
from bevy_raytrace_tpu_torch.kernels.clusters import cluster_scene
from bevy_raytrace_tpu_torch.utils import spans
from bevy_raytrace_tpu_torch.wavefront import engine

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

_BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(_BENCH) not in sys.path:
    sys.path.insert(0, str(_BENCH))

from brtbench import scene_flake  # noqa: E402


def _block(level):
    conf = json.loads((_BENCH / "configs" / "sphereflake.json").read_text())
    block = dict(conf["scene"])
    block["flake"] = dict(block["flake"], level=level)
    return block


@pytest.mark.parametrize("level,count", [(2, 91), (4, 7381)])
def test_flake_equals_the_benchmarks_generator(level, count):
    """1 + 9 + ... + 9^level spheres after the ground, as
    brtbench/scene_flake.py builds them from the configuration: the same
    centers (to float32's last bits: the two turn by different formulas),
    radii and materials, sphere by sphere."""
    scene, _ = tsc.sphereflake_scene(level)
    ref = scene_flake.build(_block(level), 2**31 + 5, "cpu")
    assert scene.count == ref.count == count + 1
    assert torch.allclose(scene.centers, ref.centers, rtol=0, atol=1e-6)
    assert torch.equal(scene.radii, ref.radii)
    mid, rid = scene.material_id.long(), ref.material_id.long()
    m = scene.materials
    assert torch.equal(m.albedo[mid], ref.albedo[rid])
    assert torch.equal(m.kind[mid], ref.kind[rid])
    assert torch.equal(m.fuzz[mid], ref.fuzz[rid])
    # the ground: a Lambertian sphere of radius 1000 whose top is y = -0.5
    assert scene.radii[0] == 1000.0 and scene.centers[0, 1] == -1000.5
    assert int(m.kind[mid[0]]) == 0 and bool((m.kind[mid[1:]] == 1).all())
    assert bool((m.fuzz[mid[1:]] == 0).all())


def test_flake_children_touch_their_parents():
    """Level order: sphere j of level k (k >= 1) is child j // 9 of level
    k - 1's, a third of its radius, its center r + r / 3 from the
    parent's; the top sphere (radius 0.5) sits on the ground."""
    scene, _ = tsc.sphereflake_scene(3)
    c = scene.centers[1:].double()
    r = scene.radii[1:].double()
    start = [0, 1, 10, 91, 820]
    for k in range(1, 4):
        kids = torch.arange(start[k], start[k + 1])
        parents = start[k - 1] + (kids - start[k]) // 9
        assert torch.allclose(r[kids], r[parents] / 3, rtol=1e-6)
        dist = torch.linalg.norm(c[kids] - c[parents], dim=1)
        assert torch.allclose(dist, r[parents] * 4 / 3, rtol=1e-6)
    assert r[0] == 0.5 and float(c[0, 1] - r[0]) == -0.5


@pytest.mark.parametrize("size", [4, 12])
def test_culled_twin_equals_dense_on_the_flake(size):
    """K1's culled twin on a level-2 flake (92 spheres), whose chunk bounds
    reach over 9x their smallest member, gives the dense twin's image and
    path lengths bit for bit."""
    scene, _ = tsc.sphereflake_scene(2)
    cfg = RenderConfig(width=40, height=40, samples_per_pixel=2,
                       max_depth=8)
    cam = tsc.sphereflake_camera(cfg.aspect)
    plan = cluster_scene(scene, size)
    _, _, cull = k1._scene_tables(scene, plan)
    r = scene.radii.abs()[torch.from_numpy(plan.perm).long()]
    r_min = torch.where(torch.from_numpy(plan.member_mask) > 0,
                        r.reshape(plan.n_clusters, size), torch.inf
                        ).min(1).values
    assert float((cull.bounds[:, 3].sqrt() / r_min).max()) > 9
    dense = k1.render_mxu_with_len(scene, cam, cfg)
    culled = k1.render_mxu_with_len(scene, cam, cfg, plan=plan)
    assert torch.equal(culled[0], dense[0]) and torch.equal(culled[1],
                                                            dense[1])


def _cpu_cuda_session(monkeypatch, calls, **kw):
    """Renderer(backend="cuda") on the CPU: its device check sees a CUDA
    device, and the frames' render_probed / render_mxu are recorded with
    their plan before they run K1's twins."""
    monkeypatch.setattr(engine, "resolve",
                        lambda device: types.SimpleNamespace(type="cuda"))
    for name in ("render_probed", "render_mxu"):
        fn = getattr(k1, name)

        def recorded(*a, _fn=fn, _name=name, **k):
            calls.append((_name, k.get("plan")))
            return _fn(*a, **k)

        monkeypatch.setattr(k1, name, recorded)
    # More samples than the probe's: the probe frame sums two passes.
    cfg = RenderConfig(width=24, height=16,
                       samples_per_pixel=engine.PROBE_SPP + 2, max_depth=3)
    return engine.Renderer(cfg, backend="cuda", **kw), cfg


def test_cuda_session_is_dense_unless_asked(monkeypatch):
    """A "cuda" session not given a cluster size plans nothing and passes no
    plan (today's dense launches, in today's lane order), as does
    cluster_size=0; "pallas" keeps its own default of 12."""
    scene, _ = tsc.sphereflake_scene(2)
    cam = tsc.sphereflake_camera(1.5)
    for kw in ({}, {"cluster_size": 0}):
        calls = []
        r, _ = _cpu_cuda_session(monkeypatch, calls, **kw)
        spans.reset_counters("k1.")
        for _ in range(3):
            r.render_frame(scene, cam)
        assert r.cluster_size == 0 and r._plans == {}
        assert calls == [("render_probed", None), ("render_mxu", None),
                         ("render_mxu", None)]
        probe_perm = k1.render_probed(scene, cam, r.config, 0,
                                      engine.PROBE_SPP)[1]
        assert torch.equal(r._perm, probe_perm)  # today's lane order
        assert spans.counter("k1.plans_built") == 0
    assert engine.Renderer(RenderConfig(), backend="pallas",
                           device="cpu").cluster_size == 12


def test_cuda_session_culls_when_asked(monkeypatch):
    """Renderer("cuda", cluster_size=12): one plan for a session of many
    frames (k1.plans_built, span k1.plan), passed to the probe frame and to
    every frame on the cached permutation, which is `culled_perm`'s (a
    probe of seed 0, reversed), the same for a session of another seed;
    each image is the dense session's bit for bit;
    replan() drops plan and permutation; a scene under 32 spheres gets no
    plan."""
    from torch.profiler import ProfilerActivity, profile

    scene, _ = tsc.sphereflake_scene(2)
    cam = tsc.sphereflake_camera(1.5)
    calls = []
    r, _ = _cpu_cuda_session(monkeypatch, calls, cluster_size=12)
    dense, _ = _cpu_cuda_session(monkeypatch, [])
    spans.reset_counters("k1.")
    spans.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        imgs = [r.render_frame(scene, cam) for _ in range(4)]
    assert spans.counter("k1.plans_built") == 1
    assert [s.name for s in spans.spans()].count("k1.plan") == 1
    spans.clear_spans()
    plan = r._plans[(scene.count, 12)]
    assert plan.cluster_size == 12
    assert calls == [("render_probed", plan)] + [("render_mxu", plan)] * 3
    perm = engine.culled_perm(scene, cam, r.config, plan)
    _, len_map = k1.render_mxu_with_len(
        scene, cam, r.config.replace(samples_per_pixel=engine.PROBE_SPP,
                                     seed=0), 0, plan=plan)
    assert torch.equal(perm, k1.balance_perm(len_map).flip(0))
    assert torch.equal(r._perm, perm)  # costliest lanes first
    other = engine.culled_perm(scene, cam, r.config.replace(seed=99), plan)
    assert torch.equal(other, perm)  # whatever the session's seed
    for img in imgs:
        assert torch.equal(img, dense.render_frame(scene, cam))
    r.replan()
    assert r._plans == {} and r._perm is None
    r.render_frame(scene, cam)
    assert spans.counter("k1.plans_built") == 2
    assert calls[-1] == ("render_probed", r._plans[(scene.count, 12)])
    small, _ = tsc.baseline_config2_scene()
    r.render_frame(small, cam)
    assert r._plans[(small.count, 12)] is None
    assert spans.counter("k1.plans_built") == 2
