"""K1's chunk-culled traversal (`plan=`) on the CPU: its plain twin against
the JAX package's culled TPU kernel (run as its own tests run it,
`interpret=True`), against the dense twin bit for bit, its live-chunk
count, and the wrapper's refusals.  The CUDA kernel's own tests are in
test_torch_cuda.py.

Bounds: against the reference, the bound of test_torch_k1.py's
`test_twin_matches_tpu_kernel` for rtiow_final (parity.COMPILED; len off on
at most as many pixels as the image bound allows).  Culled against dense:
bit for bit, image and len; the cull only drops roots that cannot win.
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
from bevy_raytrace_tpu_torch.kernels.common import _plain_camera
from bevy_raytrace_tpu_torch.parity import COMPILED, compare
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
    before = k1.render_lanes.launches
    got_img, got_len = k1.render_mxu_with_len(
        scene, camera_from_reference(jcam), RenderConfig(**KW), 0, plan=plan)
    assert k1.render_lanes.launches == before  # the twin is no launch
    stats = compare(got_img.numpy(), want_img, COMPILED)
    assert stats["ok"], stats
    off = np.abs(got_len.numpy() - want_len) > 1e-6
    assert off.mean() <= COMPILED.bad_frac, off.mean()


def _scene(name):
    cfg = RenderConfig(**KW)
    if name == "config1":
        scene, _ = tsc.baseline_config1_scene()
        return scene, tsc.baseline_config1_camera(cfg.aspect), cfg
    scene, _ = tsc.rtiow_final_scene(seed=3, grid=3)
    return scene, tsc.rtiow_final_camera(cfg.aspect), cfg


def _assert_culled_is_dense(scene, cam, cfg, plan):
    dense = k1.render_mxu_with_len(scene, cam, cfg)
    culled = k1.render_mxu_with_len(scene, cam, cfg, plan=plan)
    assert torch.equal(culled[0], dense[0])  # image
    assert torch.equal(culled[1], dense[1])  # len
    return dense


@pytest.mark.parametrize("name", ["config1", "rtiow_final"])
@pytest.mark.parametrize("size", [1, 8, 12, "all"])
def test_culled_twin_bitwise_dense(name, size):
    """Cluster sizes 1, 8, 12 and one chunk holding every sphere, on
    config1's 2 spheres (fewer than a chunk) and on rtiow grid 3."""
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
    """Config2's four small spheres, one chunk, one bounce: a
    lane's count is how many of its camera rays meet the chunk's bounding
    sphere (far root > t_min), checked in float64."""
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
        hb = oc[0] * dx + oc[1] * dy + oc[2] * dz
        far = torch.sqrt(hb * hb - (oc * oc).sum(0) + b[3]) - hb
        meets += (far > cfg.t_min).float()
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
