"""K1's chunk-culled traversal (`plan=`) on the CPU: its plain twin against
the JAX package's culled TPU kernel (run as its own tests run it,
`interpret=True`), against the dense twin bit for bit, its live-chunk
count, and the wrapper's refusals.  The CUDA kernel's own tests are in
test_torch_cuda.py.

Bounds: against the reference, the bound of test_torch_k1.py's
`test_twin_matches_tpu_kernel` for rtiow_final (parity.COMPILED; len off on
at most as many pixels as the image bound allows).  Culled against dense:
bit for bit, image and len; the cull only drops roots that cannot win.
The chunk test against the member test: every grazing ray the member
test's expression calls a hit keeps its chunk live, exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bevy_raytrace_tpu import RenderConfig as JConfig
from bevy_raytrace_tpu import scenes as jsc
from bevy_raytrace_tpu.kernels.clusters import cluster_scene as j_cluster
from bevy_raytrace_tpu.kernels.mxu_render import render_mxu_with_len as j_k1
from bevy_raytrace_tpu_torch import RenderConfig
from bevy_raytrace_tpu_torch import set_default_device
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch.interop import (
    camera_from_reference,
    scene_from_reference,
)
from bevy_raytrace_tpu_torch.kernels import render_lanes as k1
from bevy_raytrace_tpu_torch.kernels.clusters import ClusterPlan, cluster_scene
from bevy_raytrace_tpu_torch.kernels.common import _plain_camera, _rsqrt_guard
from bevy_raytrace_tpu_torch.parity import COMPILED, compare
from bevy_raytrace_tpu_torch.profile_grad import random_scene
from bevy_raytrace_tpu_torch.utils import spans
from bevy_raytrace_tpu_torch.wavefront.render import frame_seed

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

# The reference test's shape (tests/test_mxu.py, culled bit-identical).
KW = dict(width=64, height=32, samples_per_pixel=2, max_depth=4)


@pytest.fixture(scope="module")
def reference_culled():
    """The reference's culled kernel on rtiow_final(seed=3, grid=3), cluster
    size 8 -> (its scene, camera, plan, image, len), run once."""
    jscene, _ = jsc.rtiow_final_scene(seed=3, grid=3)
    jcam = jsc.rtiow_final_camera(KW["width"] / KW["height"])
    jplan = j_cluster(jscene, cluster_size=8)
    img, ln = j_k1(jscene, jcam, JConfig(**KW), 0, interpret=True,
                   plan=jplan)
    return jscene, jcam, jplan, np.asarray(img), np.asarray(ln)


def test_culled_twin_matches_tpu_kernel(reference_culled):
    jscene, jcam, jplan, want_img, want_len = reference_culled
    scene = scene_from_reference(jscene)
    plan = cluster_scene(scene, cluster_size=8)
    # The port plans as the reference does: the same Morton order.
    np.testing.assert_array_equal(plan.perm, np.asarray(jplan.perm))
    np.testing.assert_array_equal(plan.prio, np.asarray(jplan.prio))
    before = spans.counter("k1.launches")
    got_img, got_len = k1.render_mxu_with_len(
        scene, camera_from_reference(jcam), RenderConfig(**KW), 0, plan=plan)
    assert spans.counter("k1.launches") == before  # the twin is no launch
    stats = compare(got_img.numpy(), want_img, COMPILED)
    assert stats["ok"], stats
    off = np.abs(got_len.numpy() - want_len) > 1e-6
    assert off.mean() <= COMPILED.bad_frac, off.mean()


def _scene(name):
    cfg = RenderConfig(**KW)
    if name == "config1":
        scene, _ = tsc.baseline_config1_scene()
        return scene, tsc.baseline_config1_camera(cfg.aspect), cfg
    if name == "seeded_2000":
        return random_scene(2000, seed=3), tsc.rtiow_final_camera(cfg.aspect
                                                                   ), cfg
    scene, _ = tsc.rtiow_final_scene(seed=3, grid=3)
    return scene, tsc.rtiow_final_camera(cfg.aspect), cfg


def _assert_culled_is_dense(scene, cam, cfg, plan):
    dense = k1.render_mxu_with_len(scene, cam, cfg)
    culled = k1.render_mxu_with_len(scene, cam, cfg, plan=plan)
    assert torch.equal(culled[0], dense[0])  # image
    assert torch.equal(culled[1], dense[1])  # len
    return dense


@pytest.mark.parametrize("name", ["config1", "rtiow_final", "seeded_2000"])
@pytest.mark.parametrize("size", [1, 8, 12, "all"])
def test_culled_twin_bitwise_dense(name, size):
    """Cluster sizes 1, 8, 12 and one chunk holding every sphere, on
    config1's 2 spheres (fewer than a chunk), rtiow grid 3 and 2,000
    seeded small spheres."""
    scene, cam, cfg = _scene(name)
    plan = cluster_scene(scene, scene.count if size == "all" else size)
    assert plan.n_clusters == -(-scene.count // plan.cluster_size)
    img, _ = _assert_culled_is_dense(scene, cam, cfg, plan)
    assert float(img.max()) > 0.0


def _with_twin(scene, k, material):
    """`scene` plus a copy of sphere k, appended (so the higher scene
    index), with another material."""
    def cat(a, row):
        return torch.cat([a, row[None]])

    return dataclasses.replace(
        scene, centers=cat(scene.centers, scene.centers[k]),
        radii=cat(scene.radii, scene.radii[k]),
        material_id=cat(scene.material_id,
                        torch.tensor(material, dtype=scene.material_id.dtype)))


def test_tie_goes_to_the_lower_scene_index():
    """Sphere 1 of config2 twice, the copy in another material and in
    another chunk that comes FIRST in the plan's order: every exact tie
    must go to the lower scene index, so the copy never wins and the image
    is that of the scene without it, culled or dense."""
    cfg = RenderConfig(**KW)
    scene, _ = tsc.baseline_config2_scene()
    cam = tsc.baseline_config2_camera(cfg.aspect)
    twin = _with_twin(scene, 1, 3)  # the copy is metal, the original not
    n = twin.count
    order = np.array([n - 1, *range(n - 1)], np.int32)  # the copy first
    for size in (1, 2):
        c = -(-n // size)
        perm = np.concatenate([order, np.full(c * size - n, order[-1],
                                              np.int32)])
        mask = (np.arange(c * size) < n).astype(np.float32).reshape(c, size)
        plan = ClusterPlan(perm=perm, member_mask=mask,
                           prio=np.array([1, n - 1], np.int32),
                           cluster_size=size, n_clusters=c)
        img, ln = _assert_culled_is_dense(twin, cam, cfg, plan)
        alone_img, alone_len = k1.render_mxu_with_len(scene, cam, cfg)
        assert torch.equal(img, alone_img) and torch.equal(ln, alone_len)


def test_culled_after_the_spheres_move():
    """The plan is built once; the bounds follow the live geometry, so the
    culled render of moved spheres is still the dense one."""
    scene, cam, cfg = _scene("rtiow_final")
    plan = cluster_scene(scene, cluster_size=8)
    rng = np.random.default_rng(5)
    shift = rng.uniform(-0.6, 0.6, (scene.count, 3)).astype(np.float32)
    shift[:, 1] *= 0.2
    moved = dataclasses.replace(scene,
                                centers=scene.centers + torch.from_numpy(shift))
    _assert_culled_is_dense(moved, cam, cfg, plan)


def _lanes(scene, cam, cfg, plan, **kw):
    geom, attr, cull = k1._scene_tables(scene, plan)
    pids = torch.arange(k1.lane_pad(cfg.num_pixels), dtype=torch.int32)
    return k1.render_lanes(geom, attr, cam.pack(), pids, frame_seed(cfg, 0),
                           0, cfg.samples_per_pixel, cfg.max_depth, cfg.t_min,
                           cfg.width, cfg.height, cull=cull, count_live=True,
                           **kw)


def test_live_count_lies_within_the_chunks_of_each_round():
    scene, cam, cfg = _scene("rtiow_final")
    plan = cluster_scene(scene, cluster_size=1)
    fb, ln, live = _lanes(scene, cam, cfg, plan)
    assert bool((live >= 0).all())
    assert bool((live <= plan.n_clusters * ln).all())
    assert 0 < float(live.sum()) < plan.n_clusters * float(ln.sum())
    # One chunk whose bound holds the camera: every round's ray starts
    # inside it, so every round has it live.
    one = cluster_scene(scene, cluster_size=scene.count)
    fb1, ln1, live1 = _lanes(scene, cam, cfg, one)
    assert torch.equal(live1, ln1)
    assert torch.equal(fb1, fb) and torch.equal(ln1, ln)
    # max_rounds stops every lane after that many rounds.
    _, ln2, live2 = _lanes(scene, cam, cfg, one, max_rounds=3)
    assert torch.equal(ln2, ln.clamp(max=3)) and torch.equal(live2, ln2)


def test_live_count_of_one_chunk_is_the_rays_that_meet_its_bound():
    """Config2's four small spheres, one chunk, one bounce: a lane's count
    is how many of its camera rays pass the chunk test, checked in float64:
    the point of [t_min, inf) nearest the bound's center within br^2 plus
    the slack.  (A clamp at t_ub changes nothing here: t_ub is the root of
    a sphere inside the bound, so that point passes too.)"""
    base, _ = tsc.baseline_config2_scene()
    keep = base.radii < 10.0  # drop the ground: a bound the camera is out of
    scene = dataclasses.replace(base, centers=base.centers[keep],
                                radii=base.radii[keep],
                                material_id=base.material_id[keep])
    cfg = RenderConfig(width=48, height=32, samples_per_pixel=3, max_depth=1)
    cam = tsc.rtiow_final_camera(cfg.aspect)  # they fill part of its view
    plan = cluster_scene(scene, cluster_size=scene.count)
    _, ln, live = _lanes(scene, cam, cfg, plan)
    (b,) = k1._scene_tables(scene, plan)[2].bounds.double()
    pid = torch.arange(k1.lane_pad(cfg.num_pixels), dtype=torch.int64)
    meets = torch.zeros(pid.shape, dtype=torch.float32)
    for s in range(cfg.samples_per_pixel):
        ox, oy, oz, dx, dy, dz = (v.double() for v in _plain_camera(
            cam.pack(), pid, s, frame_seed(cfg, 0), cfg.width, cfg.height))
        oc = torch.stack([ox - b[0], oy - b[1], oz - b[2]])
        d = torch.stack([dx, dy, dz])
        hb = (oc * d).sum(0)
        v2 = ((oc + torch.clamp(-hb, min=cfg.t_min) * d) ** 2).sum(0)
        slack = k1.CULL_SLACK * 2.0 ** -24 * (v2 + hb * hb)
        meets += (v2 <= b[3] + slack).float()
    assert torch.equal(ln, torch.full_like(ln, cfg.samples_per_pixel))
    assert torch.equal(live, meets)
    assert 0 < float(live.sum()) < float(ln.sum())  # some miss, some meet


def test_wrapper_refuses_a_plan_or_operands_that_do_not_fit():
    scene, cam, cfg = _scene("rtiow_final")
    other, _ = tsc.rtiow_final_scene(seed=3, grid=2)
    with pytest.raises(ValueError, match="spheres"):
        k1.render_mxu(scene, cam, cfg, plan=cluster_scene(other, 8))
    with pytest.raises(TypeError, match="ClusterPlan"):
        k1.render_mxu(scene, cam, cfg, plan=object())
    geom, attr, cull = k1._scene_tables(scene, cluster_scene(scene, 8))
    pids = torch.arange(k1.lane_pad(cfg.num_pixels), dtype=torch.int32)
    args = (geom, attr, cam.pack(), pids, frame_seed(cfg, 0), 0, 1, 2,
            cfg.t_min, cfg.width, cfg.height)
    bad = {
        "bounds": cull._replace(bounds=cull.bounds[1:].contiguous()),
        "members": cull._replace(members=cull.members.long()),
        "prio": cull._replace(prio=cull.prio[:, :3].contiguous()),
        "cluster_size": cull._replace(cluster_size=0),
    }
    for name, c in bad.items():
        with pytest.raises((ValueError, TypeError), match=name):
            k1.render_lanes(*args, cull=c)
    with pytest.raises(TypeError, match="CullTables"):
        k1.render_lanes(*args, cull=tuple(cull))
    with pytest.raises(ValueError, match="need cull"):
        k1.render_lanes(*args, count_live=True)
    with pytest.raises(ValueError, match="max_rounds"):
        k1.render_lanes(*args, cull=cull, max_rounds=-1)
    fb, ln = k1.render_lanes(*args, cull=cull)
    assert fb.shape == (pids.shape[0], 3) and ln.shape == pids.shape


def test_row_of_inverts_the_reference_plans_members(reference_culled):
    """The culled operands' row_of (scene index -> row, which the CUDA
    kernel reads to turn a winning (t, scene index) key into its row) is
    the inverse of members, the reference plan's Morton order without its
    pad slots; the row it names holds that scene index's sphere."""
    jscene, _, jplan, _, _ = reference_culled
    scene = scene_from_reference(jscene)
    n = scene.count
    geom, attr, cull = k1._scene_tables(scene, cluster_scene(scene, 8))
    perm = np.asarray(jplan.perm)
    assert np.asarray(jplan.member_mask).reshape(-1)[:n].all()
    np.testing.assert_array_equal(cull.members.numpy(), perm[:n])
    assert cull.row_of.dtype == torch.int32 and cull.row_of.is_contiguous()
    every = torch.arange(n, dtype=torch.int32)
    assert torch.equal(cull.row_of[cull.members.long()], every)
    assert torch.equal(cull.members[cull.row_of.long()], every)
    scene_geom, scene_attr = k1._scene_tables(scene)
    assert torch.equal(geom[cull.row_of.long()], scene_geom)
    assert torch.equal(attr[cull.row_of.long()], scene_attr)


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_wrapper_refuses_a_row_of_that_does_not_fit(bad):
    scene, cam, cfg = _scene("rtiow_final")
    geom, attr, cull = k1._scene_tables(scene, cluster_scene(scene, 8))
    pids = torch.arange(k1.lane_pad(cfg.num_pixels), dtype=torch.int32)
    row_of = (cull.row_of.long() if bad == "dtype"
              else cull.row_of[1:].contiguous())
    with pytest.raises((ValueError, TypeError), match="row_of"):
        k1.render_lanes(geom, attr, cam.pack(), pids, frame_seed(cfg, 0), 0,
                        1, 2, cfg.t_min, cfg.width, cfg.height,
                        cull=cull._replace(row_of=row_of))


def test_cull_slack_is_the_kernels():
    """The twin's slack is the CUDA kernel's BRT_K1_CULL_SLACK."""
    import re
    from pathlib import Path

    src = (Path(k1.__file__).parents[1] / "csrc" / "k1_render.cu").read_text()
    (value,) = re.findall(r"^#define BRT_K1_CULL_SLACK (\d+)$", src, re.M)
    assert int(value) == k1.CULL_SLACK


def _fma(a, b, c):
    """a * b + c rounded once to float32, as the card's fma: the product is
    exact in float64 (its rounding to float64 then float32 can differ from
    one rounding only at a float64 half-way point)."""
    return (a.double() * b.double() + c.double()).float()


def _member_hit(g, o, d, arith):
    """The member test's verdict (rounded disc > 0) for each ray and its own
    sphere row g = (cx, cy, cz, r^2): the twin's expression (`_plain_root`,
    every operation rounded), or the CUDA sweep's contracted to fmas."""
    if arith == "twin":
        t = k1._plain_root(*g.unbind(1), *o.unbind(1), *d.unbind(1), 1e-3)
        return ~torch.isnan(t)
    oc = o - g[:, :3]
    hb = _fma(oc[:, 2], d[:, 2], _fma(oc[:, 1], d[:, 1], oc[:, 0] * d[:, 0]))
    cq = _fma(oc[:, 2], oc[:, 2], _fma(oc[:, 1], oc[:, 1],
                                       oc[:, 0] * oc[:, 0])) - g[:, 3]
    return _fma(hb, hb, -cq) > 0


def _chunk_live_fma(b, o, d, t_min, slack):
    """csrc/k1_render.cu's chunk_live with its fmas (t_ub none)."""
    ob = o - b[:, :3]
    hb = _fma(ob[:, 0], d[:, 0], _fma(ob[:, 1], d[:, 1], ob[:, 2] * d[:, 2]))
    ts = torch.clamp(-hb, min=t_min)
    v = [_fma(ts, d[:, i], ob[:, i]) for i in range(3)]
    v2 = _fma(v[0], v[0], _fma(v[1], v[1], v[2] * v[2]))
    return v2 <= _fma(torch.full_like(v2, slack * 2.0 ** -24),
                      _fma(hb, hb, v2), b[:, 3])


@pytest.mark.parametrize("arith", ["twin", "fma"])
@pytest.mark.parametrize("size", [1, 2, 4])
def test_grazing_hits_keep_their_chunk_live(arith, size, monkeypatch):
    """2,000 seeded spheres at cluster size 1, 2 and 4; from (13, 2, 3), 400
    rays at each small sphere, aimed past its center at r (1 + delta),
    delta in [0, 3e-3], normalized in float32 as the renderer does: on a
    random side at size 1, on the side away from the bound's center (where
    the sphere touches its chunk's bound) above.  The member test's
    rounding calls some of these misses hits; every ray it calls a hit must
    have its sphere's chunk live under the chunk test, in the twin's
    arithmetic (every operation rounded) and in the kernel's (fmas).
    Without the slack (slack 0: the bare closest-point test) the chunk
    test culls some of them: the rays reach the fault the slack repairs.
    A quarter of the slack still covers them (the derivation at the
    kernel's chunk_live allows for worse rounding than these rays meet)."""
    scene = random_scene(2000, seed=3)
    geom, _, cull = k1._scene_tables(scene, cluster_scene(scene, size))
    rng = np.random.default_rng(0)
    small = np.flatnonzero(geom[:, 3].numpy() < 1.0)
    row = np.repeat(small, 400)
    b = cull.bounds[row // size]  # chunk c holds rows [c L, (c + 1) L)
    c = geom[row, :3].double().numpy()
    r = np.sqrt(geom[row, 3].double().numpy())
    origin = np.array([13.0, 2.0, 3.0])
    w = c - origin
    w /= np.linalg.norm(w, axis=1)[:, None]
    side = rng.normal(size=c.shape)
    if size > 1:
        side = c - b[:, :3].double().numpy() + 1e-3 * side
    side -= (side * w).sum(1)[:, None] * w
    side /= np.linalg.norm(side, axis=1)[:, None]
    aim = c + side * (r * (1 + rng.uniform(0.0, 3e-3, r.shape)))[:, None]
    t = torch.from_numpy(aim - origin).float()
    d = t * _rsqrt_guard((t * t).sum(1, keepdim=True))
    o = torch.tensor(origin, dtype=torch.float32).expand_as(d)
    hit = _member_hit(geom[row], o, d, arith)

    slack = k1.CULL_SLACK

    def live(s):
        if arith == "fma":
            return _chunk_live_fma(b, o, d, 1e-3, s)
        monkeypatch.setattr(k1, "CULL_SLACK", s)
        return k1._chunk_live(*b.unbind(1), *o.unbind(1), *d.unbind(1),
                              1e-3, torch.tensor(k1._NO_BOUND))

    assert int(hit.sum()) > 10_000  # grazing hits, most just outside
    assert int((hit & ~live(0)).sum()) >= 10  # the fault, without the slack
    assert int((hit & ~live(slack)).sum()) == 0
    # and with room: a quarter of the slack keeps them all too
    assert int((hit & ~live(slack // 4)).sum()) == 0
