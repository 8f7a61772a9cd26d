"""K1's scene tables kept between frames (`render_lanes._cached_scene_tables`,
which `render_mxu_lanes` calls): reused while the scene's seven source
tensors and the plan are unchanged, rebuilt, bit for bit as a fresh
`_scene_tables` of the edited scene, after any in-place edit or new tensor.
The CPU twin's tables; the card's session is in test_torch_cuda.py."""

import copy
import dataclasses
import os
import sys
import threading

import pytest
import torch

from bevy_raytrace_tpu_torch import RenderConfig, set_default_device
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch.kernels import render_lanes as k1
from bevy_raytrace_tpu_torch.kernels.clusters import cluster_scene
from bevy_raytrace_tpu_torch.utils import spans

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

CFG = RenderConfig(width=32, height=16, samples_per_pixel=2, max_depth=3)


@pytest.fixture(autouse=True)
def fresh():
    """An empty cache and zeroed table counters before and after."""
    k1._tables.clear()
    spans.reset_counters("k1.tables")
    yield
    k1._tables.clear()
    spans.reset_counters("k1.tables")


def _scene():
    return tsc.rtiow_final_scene(seed=3, grid=2)[0]


def _equal(got, want):
    """Tables (and a plan's CullTables) equal bit for bit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, k1.CullTables):
            assert g.cluster_size == w.cluster_size
            _equal(g[:4], w[:4])
        else:
            assert g.dtype == w.dtype and torch.equal(g, w)


def _counted():
    return spans.counters("k1.tables")


def test_a_static_scene_gets_the_same_tables_back():
    scene = _scene()
    first = k1._cached_scene_tables(scene)
    assert _counted() == {"k1.tables_built": 1}
    _equal(first, k1._scene_tables(scene))
    spans.reset_counters("k1.tables")
    again = k1._cached_scene_tables(scene)
    assert _counted() == {"k1.tables_reused": 1}
    assert all(a is b for a, b in zip(again, first))


def _edit(scene, name):
    """Edit one source tensor in place, so that the tables change."""
    m = scene.materials
    mid = int(scene.material_id[0])
    other = int(scene.material_id[-1])
    assert other != mid
    if name == "centers":
        scene.centers[0] += torch.tensor([0.25, -0.5, 0.125])
    elif name == "radii":
        scene.radii[1] *= 1.5
    elif name == "material_id":
        scene.material_id[0] = other
    elif name == "albedo":
        m.albedo[mid] = torch.tensor([0.1, 0.7, 0.3])
    elif name == "kind":
        m.kind[mid] = (m.kind[mid] + 1) % 3
    elif name == "fuzz":
        m.fuzz[mid] += 0.25
    else:
        m.ior[mid] += 0.5


@pytest.mark.parametrize("name", ["centers", "radii", "material_id",
                                  "albedo", "kind", "fuzz", "ior"])
def test_an_in_place_edit_rebuilds(name):
    """Each source edited in place: the next ask builds, and its tables are
    a fresh build of a deep copy of the edited scene, bit for bit."""
    scene = _scene()
    before = [t.clone() for t in k1._cached_scene_tables(scene)]
    _edit(scene, name)
    spans.reset_counters("k1.tables")
    got = k1._cached_scene_tables(scene)
    assert _counted() == {"k1.tables_built": 1}
    _equal(got, k1._scene_tables(copy.deepcopy(scene)))
    assert not all(torch.equal(a, b) for a, b in zip(got, before))
    assert len(k1._tables) == 1  # the entry was replaced, not added to
    spans.reset_counters("k1.tables")
    assert k1._cached_scene_tables(scene)[0] is got[0]
    assert _counted() == {"k1.tables_reused": 1}


def test_a_field_given_a_new_tensor_rebuilds():
    scene = _scene()
    k1._cached_scene_tables(scene)
    scene.radii = scene.radii * 2.0
    moved = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, fuzz=scene.materials.fuzz.clone()))
    for s in (scene, moved):
        spans.reset_counters("k1.tables")
        got = k1._cached_scene_tables(s)
        assert _counted() == {"k1.tables_built": 1}
        _equal(got, k1._scene_tables(copy.deepcopy(s)))


def test_plan_ordered_tables_follow_a_moved_center():
    """The chunk bounds and the priority rows are rebuilt from the live
    geometry when a priority sphere moves in place; the plan-ordered and
    scene-ordered tables of one scene are separate entries."""
    scene = _scene()
    plan = cluster_scene(scene, 4)
    old = k1._cached_scene_tables(scene, plan)
    dense = k1._cached_scene_tables(scene)
    assert _counted() == {"k1.tables_built": 2}
    cull = old[2]
    assert isinstance(cull, k1.CullTables)
    bounds, prio = cull.bounds.clone(), cull.prio.clone()
    scene.centers[int(plan.prio[0])] += torch.tensor([1.5, 0.0, -2.0])
    spans.reset_counters("k1.tables")
    got = k1._cached_scene_tables(scene, plan)
    assert _counted() == {"k1.tables_built": 1}
    _equal(got, k1._scene_tables(copy.deepcopy(scene), plan))
    assert not torch.equal(got[2].bounds, bounds)
    assert not torch.equal(got[2].prio, prio)
    spans.reset_counters("k1.tables")
    assert k1._cached_scene_tables(scene, cluster_scene(scene, 4)) is not got
    assert k1._cached_scene_tables(scene)[0] is not dense[0]
    assert _counted() == {"k1.tables_built": 2}


def test_an_inference_mode_scene_rebuilds_every_time():
    with torch.inference_mode():
        scene = _scene()
        want = k1._scene_tables(scene)
        for _ in range(3):
            _equal(k1._cached_scene_tables(scene), want)
        img = k1.render_mxu(scene, tsc.rtiow_final_camera(CFG.aspect), CFG)
    assert _counted() == {"k1.tables_built": 4}
    assert len(k1._tables) == 0
    assert img.shape == (CFG.height, CFG.width, 3)


def test_the_cache_stays_within_its_bound():
    """More scenes than the bound: the oldest entries go first, the newest
    are reused."""
    scenes = [tsc.rtiow_final_scene(seed=s, grid=2)[0]
              for s in range(k1.MAX_TABLES + 3)]
    for s in scenes:
        k1._cached_scene_tables(s)
        assert len(k1._tables) <= k1.MAX_TABLES
    assert _counted() == {"k1.tables_built": len(scenes)}
    spans.reset_counters("k1.tables")
    k1._cached_scene_tables(scenes[-1])
    k1._cached_scene_tables(scenes[0])
    assert _counted() == {"k1.tables_reused": 1, "k1.tables_built": 1}
    assert len(k1._tables) == k1.MAX_TABLES


def test_threads_share_the_cache_safely():
    """More threads than cores asking for six scenes' tables at once, with
    the interpreter switching threads as often as it can: each gets its
    scene's tables, every ask is counted, the cache never passes its
    bound."""
    scenes = [tsc.rtiow_final_scene(seed=s, grid=2)[0] for s in range(6)]
    want = [k1._scene_tables(s) for s in scenes]
    errors, sizes = [], []
    n_threads, n_asks = (os.cpu_count() or 8) + 1, 30

    def ask(t):
        try:
            for i in range(n_asks):
                j = (i + t) % len(scenes)
                _equal(k1._cached_scene_tables(scenes[j]), want[j])
                sizes.append(len(k1._tables))
        except AssertionError as e:
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert max(sizes) <= k1.MAX_TABLES
    assert sum(_counted().values()) == n_threads * n_asks


def test_renders_follow_an_in_place_move():
    """Through the twin's render: a static scene's frames reuse the
    tables, a sphere moved in place is rendered where it now is; each
    frame equals the render of a deep copy of the scene as it then was."""
    scene = _scene()
    cam = tsc.rtiow_final_camera(CFG.aspect)
    want = [k1.render_mxu(copy.deepcopy(scene), cam, CFG, f)
            for f in range(4)]
    k1._tables.clear()
    spans.reset_counters("k1.tables")
    frames = [k1.render_mxu(scene, cam, CFG, f) for f in range(3)]
    assert _counted() == {"k1.tables_built": 1, "k1.tables_reused": 2}
    scene.centers[17] += torch.tensor([0.0, 0.3, 0.0])  # the middle hero
    frames.append(k1.render_mxu(scene, cam, CFG, 3))
    assert _counted() == {"k1.tables_built": 2, "k1.tables_reused": 2}
    for got, w in zip(frames[:3], want):
        assert torch.equal(got, w)
    assert not torch.equal(frames[3], want[3])
    assert torch.equal(frames[3], k1.render_mxu(copy.deepcopy(scene), cam,
                                                CFG, 3))
