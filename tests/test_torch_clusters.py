"""The port's cluster-culled traversal against the JAX package's:
`kernels/clusters.py` (the plan and the live bounds), K2's plain twin with
`clusters=` against `render_pallas(..., clusters=plan, interpret=True)`, and
`make_fast_renderer(clusters=plan)`.

Bounds:
  * the plan: `perm`, `member_mask`, `prio` and the sizes EQUAL the
    reference's (the same numpy arithmetic on the same centers);
  * `cluster_bounds`: 1e-6 relative to each array's max-abs (float32 sums in
    another order), and every member inside its cluster's bound;
  * twin with a plan vs the TPU kernel with the same plan (interpret mode):
    image under parity.INTERPRET, residuals (the JAX ones mapped through
    `plan.perm` to scene indices) equal on >= 99.9% of entries;
  * twin with a plan vs twin without: image and residuals bit-identical on
    the scene of tests/test_pallas.py::test_clustered_traversal_bit_identical
    for its three cluster sizes (the members see the same arithmetic; only
    the order of exact ties could differ);
  * stripes with a plan compose bit for bit;
  * gradients: parity.grad_close at rtol 2e-3.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bevy_raytrace_tpu import RenderConfig as JConfig
from bevy_raytrace_tpu import scenes as jsc
from bevy_raytrace_tpu.inverse import make_fast_renderer as j_fast
from bevy_raytrace_tpu.kernels.clusters import cluster_bounds as j_bounds
from bevy_raytrace_tpu.kernels.clusters import cluster_scene as j_cluster_scene
from bevy_raytrace_tpu.kernels.pallas_render import render_pallas as j_pallas
from bevy_raytrace_tpu_torch import RenderConfig
from bevy_raytrace_tpu_torch import set_default_device
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch.interop import (
    camera_from_reference,
    cluster_plan_from_reference,
    residuals_from_reference,
    scene_from_reference,
)
from bevy_raytrace_tpu_torch.inverse import make_fast_renderer, replay_image
from bevy_raytrace_tpu_torch.kernels import record as k2
from bevy_raytrace_tpu_torch.kernels.clusters import (
    ClusterPlan,
    cluster_bounds,
    cluster_scene,
)
from bevy_raytrace_tpu_torch.parity import INTERPRET, compare, grad_close

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

KW = dict(width=64, height=32, samples_per_pixel=2, max_depth=4)


def _same_plan(got: ClusterPlan, want) -> None:
    assert got.cluster_size == want.cluster_size
    assert got.n_clusters == want.n_clusters
    for name in ("perm", "member_mask", "prio"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# grid 2 has 20 spheres (neither 6, 12 nor 24 divides it), the full
# scene 486 (7 does not divide it).
@pytest.mark.parametrize("grid,size", [(2, 6), (2, 12), (2, 24), (11, 6),
                                       (11, 12), (11, 24), (11, 7)])
def test_cluster_scene_equals_the_reference_plan(grid, size):
    jscene, _ = jsc.rtiow_final_scene(seed=0, grid=grid)
    want = j_cluster_scene(jscene, cluster_size=size)
    scene = scene_from_reference(jscene)
    got = cluster_scene(scene, cluster_size=size)
    assert scene.count % size != 0 or size == 6
    _same_plan(got, want)
    _same_plan(cluster_plan_from_reference(want), want)
    assert got.n_members == scene.count
    # The port's own constructor of the same scene gives the same plan too.
    own, _ = tsc.rtiow_final_scene(seed=0, grid=grid)
    _same_plan(cluster_scene(own, cluster_size=size), want)


@pytest.mark.parametrize("grid,size", [(4, 24), (11, 12), (2, 7)])
def test_cluster_bounds_match_and_contain_every_member(grid, size):
    jscene, _ = jsc.rtiow_final_scene(seed=0, grid=grid)
    scene = scene_from_reference(jscene)
    if size % 6 == 0:
        jplan = j_cluster_scene(jscene, cluster_size=size)
        plan = cluster_plan_from_reference(jplan)
        want = [np.asarray(v) for v in j_bounds(jscene.centers, jscene.radii,
                                                jplan)]
    else:
        plan, want = cluster_scene(scene, cluster_size=size), None
    got = [v.numpy() for v in cluster_bounds(scene.centers, scene.radii,
                                             plan)]
    assert all(v.shape == (plan.n_clusters,) and v.dtype == np.float32
               for v in got)
    if want is not None:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-6 * np.abs(b).max())
    bc = np.stack(got[:3], -1).astype(np.float64)
    br = np.sqrt((bc * bc).sum(-1) - got[3].astype(np.float64))
    c = scene.centers.numpy()[plan.perm].reshape(plan.n_clusters, size, 3)
    r = np.abs(scene.radii.numpy()[plan.perm]).reshape(plan.n_clusters, size)
    extent = np.linalg.norm(c - bc[:, None, :], axis=-1) + r
    # kq = |bc|^2 - br^2 in float32 loses br to the cancellation where the
    # ground sphere (r = 1000) makes both terms ~1e6: allow its rounding.
    slack = 1e-5 + 4 * np.finfo(np.float32).eps * (bc * bc).sum(-1) / br
    assert ((extent <= br[:, None] + slack[:, None])
            | (plan.member_mask == 0)).all()


def test_twin_with_clusters_matches_tpu_kernel():
    kw = dict(width=48, height=32, samples_per_pixel=2, max_depth=3)
    jscene, _ = jsc.rtiow_final_scene(seed=3, grid=2)
    jcam = jsc.rtiow_final_camera(kw["width"] / kw["height"])
    jplan = j_cluster_scene(jscene, cluster_size=6)
    want_img, want_res, want_res2 = j_pallas(
        jscene, jcam, JConfig(**kw), 1, interpret=True, clusters=jplan,
        with_residuals=True, record_second=True)
    cfg = RenderConfig(**kw)
    plan = cluster_plan_from_reference(jplan)
    img, res, res2 = k2.render_record_plain(
        scene_from_reference(jscene), camera_from_reference(jcam), cfg, 1,
        record_second=True, clusters=plan)
    stats = compare(img.numpy(), np.asarray(want_img), INTERPRET)
    assert stats["ok"], stats
    perm = torch.from_numpy(plan.perm.astype(np.int64))
    for got, want in ((res, want_res), (res2, want_res2)):
        want = residuals_from_reference(want, cfg.num_pixels)
        # The TPU kernel records rows of its permuted table: to scene ids.
        want = torch.where(want >= 0, perm[want.long().clamp(min=0)],
                           -1).to(want.dtype)
        assert got.dtype == want.dtype == torch.int16
        assert got.shape == want.shape
        assert float((got == want).float().mean()) >= 0.999
    assert int(res.max()) < jscene.count and int(res.min()) == -1


@pytest.mark.parametrize("size", [6, 12, 24])
def test_clustered_twin_bit_identical_to_brute_force(size):
    cfg = RenderConfig(**KW)
    scene, _ = tsc.rtiow_final_scene(seed=3, grid=3)
    cam = tsc.rtiow_final_camera(cfg.aspect)
    plan = cluster_scene(scene, cluster_size=size)
    brute = k2.render_record(scene, cam, cfg, 0, record_second=True)
    culled = k2.render_record(scene, cam, cfg, 0, record_second=True,
                              clusters=plan)
    for a, b in zip(brute, culled):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # render_pallas is the same launch without residuals, in the
    # reference's return forms.
    value = k2.render_pallas(scene, cam, cfg, 0, clusters=plan)
    torch.testing.assert_close(value, brute[0], rtol=0, atol=0)
    pair = k2.render_pallas(scene, cam, cfg, 0, clusters=plan,
                            with_residuals=True)
    assert len(pair) == 2 and torch.equal(pair[1], brute[1])
    triple = k2.render_pallas(scene, cam, cfg, 0, clusters=plan,
                              with_residuals=True, record_second=True)
    assert len(triple) == 3 and torch.equal(triple[2], brute[2])


def test_stripes_with_clusters_compose_bit_for_bit():
    cfg = RenderConfig(**KW)
    scene, _ = tsc.rtiow_final_scene(seed=3, grid=2)
    cam = tsc.rtiow_final_camera(cfg.aspect)
    plan = cluster_scene(scene, cluster_size=5)
    img, res, res2 = k2.render_record(scene, cam, cfg, 2, record_second=True,
                                      clusters=plan)
    n, local = cfg.num_pixels, cfg.num_pixels // 4
    for base in range(0, n, local):
        s_img, s_res, s_res2 = k2.render_record(
            scene, cam, cfg, 2, record_second=True, clusters=plan,
            pixel_base=base, num_local=local)
        span = slice(base, base + local)
        assert torch.equal(s_img, img.reshape(n, 3)[span])
        assert torch.equal(s_res, res[:, :, span])
        assert torch.equal(s_res2, res2[:, :, span])


def test_bounds_follow_the_live_geometry():
    """A sphere moved far from where the plan saw it still renders as the
    brute-force loop does: the bounds are recomputed on every call, the
    replay of the recorded scene indices reconstructs the image, and a
    plan is uploaded to a device once."""
    cfg = RenderConfig(**KW, edge_softness=0.01)
    scene, _ = tsc.rtiow_final_scene(seed=3, grid=2)
    cam = tsc.rtiow_final_camera(cfg.aspect)
    plan = cluster_scene(scene, cluster_size=6)
    centers = scene.centers.clone()
    centers[5] += torch.tensor([3.0, 0.5, -2.0])
    centers[-1] += torch.tensor([-2.0, 0.0, 1.5])
    moved = dataclasses.replace(scene, centers=centers)
    brute = k2.render_record(moved, cam, cfg, 0, record_second=True)
    culled = k2.render_record(moved, cam, cfg, 0, record_second=True,
                              clusters=plan)
    for a, b in zip(brute, culled):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    rep = replay_image(moved, cam, cfg, culled[1], 0, res2=culled[2])
    # 5e-4: the replay solves the centered quadratic, the recorder the
    # expanded one; on this scene's small spheres they differ by more than
    # on config2 (5e-5 in test_torch_record.py).
    np.testing.assert_allclose(rep.detach().numpy(), culled[0].numpy(),
                               atol=5e-4)
    assert plan.on("cpu")[0] is plan.on(torch.device("cpu"))[0]


def _torch_grads(scene, cam, cfg, w, **options):
    fast = make_fast_renderer(cfg, **options)
    c = scene.centers.clone().requires_grad_(True)
    a = scene.materials.albedo.clone().requires_grad_(True)
    mats = dataclasses.replace(scene.materials, albedo=a)
    img = fast(dataclasses.replace(scene, centers=c, materials=mats), cam, 1)
    torch.sum(img * torch.from_numpy(w)).backward()
    return {"centers": c.grad.numpy(), "albedo": a.grad.numpy()}, img.detach()


@pytest.mark.parametrize("edge", [0.0, 0.01])
def test_fast_gradient_with_clusters(edge):
    """make_fast_renderer(clusters=plan): the gradient of the unclustered
    renderer (the same recorded paths, so bit for bit on the CPU), with and
    without `grad_spp_chunk`; and, with edge_softness 0, the JAX fast
    renderer's with the same plan.  With edge_softness 0.01 on this scene
    the JAX package's own two backwards ("kernel" and "xla") differ by 2.9%
    on one component of one sphere, with or without a plan (the silhouette
    term of a grazing path amplifies their rounding), so that case is held
    against the port's unclustered gradient only."""
    kw = dict(width=48, height=32, samples_per_pixel=2, max_depth=3,
              edge_softness=edge)
    jscene, _ = jsc.rtiow_final_scene(seed=3, grid=2)
    jcam = jsc.rtiow_final_camera(kw["width"] / kw["height"])
    jplan = j_cluster_scene(jscene, cluster_size=6)
    w = np.random.default_rng(5).standard_normal(
        (kw["height"], kw["width"], 3)).astype(np.float32)
    scene, cam = scene_from_reference(jscene), camera_from_reference(jcam)
    cfg = RenderConfig(**kw)
    plan = cluster_plan_from_reference(jplan)
    got, img = _torch_grads(scene, cam, cfg, w, clusters=plan)
    plain, plain_img = _torch_grads(scene, cam, cfg, w)
    torch.testing.assert_close(img, plain_img, rtol=0, atol=0)
    refs = [plain]
    if edge == 0.0:
        jfast = j_fast(JConfig(**kw), clusters=jplan, interpret=True)

        def loss(centers, albedo):
            mats = dataclasses.replace(jscene.materials, albedo=albedo)
            sc = dataclasses.replace(jscene, centers=centers, materials=mats)
            return jnp.sum(jfast(sc, jcam, 1) * jnp.asarray(w))

        grads = jax.grad(loss, argnums=(0, 1))(jscene.centers,
                                               jscene.materials.albedo)
        refs.append(dict(zip(("centers", "albedo"),
                             (np.asarray(g) for g in grads))))
    for ref in refs:
        glob = max(float(np.abs(v).max()) for v in ref.values())
        assert glob > 0.0
        for name in ref:
            stats = grad_close(got[name], ref[name], 2e-3, glob)
            assert stats["ok"], (name, stats)
    for name in plain:
        np.testing.assert_array_equal(got[name], plain[name])
    chunked, _ = _torch_grads(scene, cam, cfg, w, clusters=plan,
                              grad_spp_chunk=1)
    for name in plain:
        stats = grad_close(chunked[name], plain[name], 2e-3)
        assert stats["ok"], (name, stats)


def test_what_the_cluster_options_reject():
    cfg = RenderConfig(**KW)
    scene, _ = tsc.rtiow_final_scene(seed=3, grid=2)
    cam = tsc.rtiow_final_camera(cfg.aspect)
    plan = cluster_scene(scene, cluster_size=6)
    with pytest.raises(ValueError, match="unpermuted"):
        make_fast_renderer(cfg, forward="sweep", clusters=plan)
    with pytest.raises(TypeError, match="ClusterPlan"):
        make_fast_renderer(cfg, clusters=object())
    for render in (k2.render_record, k2.render_record_plain, k2.render_pallas):
        with pytest.raises(TypeError, match="ClusterPlan"):
            render(scene, cam, cfg, clusters=object())
    small, _ = tsc.baseline_config2_scene()
    with pytest.raises(ValueError, match="built for 20 spheres"):
        k2.render_pallas(small, cam, cfg, clusters=plan)
    with pytest.raises(ValueError, match="cluster_size"):
        cluster_scene(scene, cluster_size=0)


@pytest.mark.parametrize("size", [1, 5])
def test_twin_live_counts_each_pixels_rounds_and_live_clusters(size):
    """`live` through the twin (record_frame on CPU tensors): live[1] is
    each pixel's rounds, between its recorded hits and those plus one miss
    a sample; live[0] its live clusters summed over them, at least one a
    hit (the winner's cluster is live) and at most every cluster a round;
    the image and residuals are those of the launch without `live`, and a
    stripe's counts are the frame's slice."""
    cfg = RenderConfig(**KW)
    scene, _ = tsc.rtiow_final_scene(seed=3, grid=2)
    cam = tsc.rtiow_final_camera(cfg.aspect)
    table, cam16 = k2._operands(scene, cam)
    plan = cluster_scene(scene, cluster_size=size)
    live = torch.full((2, cfg.num_pixels), -5, dtype=torch.int32)
    got = k2.record_frame(table, cam16, cfg, 2, record_second=True,
                          clusters=plan, live=live)
    want = k2.record_frame(table, cam16, cfg, 2, record_second=True,
                           clusters=plan)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    pairs, rounds = live
    hits = (got[1] >= 0).sum((0, 1)).to(torch.int32)
    assert bool((rounds >= hits).all())
    assert bool((rounds <= hits + cfg.samples_per_pixel).all())
    assert bool((pairs >= hits).all())
    assert bool((pairs <= rounds * plan.n_clusters).all())
    assert int(pairs.sum()) < int(rounds.sum()) * plan.n_clusters
    n, local = cfg.num_pixels, cfg.num_pixels // 4
    part = torch.zeros((2, local), dtype=torch.int32)
    k2.record_frame_plain(table, cam16, cfg, 2, clusters=plan, live=part,
                          pixel_base=local, num_local=local)
    assert torch.equal(part, live[:, local:2 * local])


def test_live_needs_a_plan_and_its_buffer():
    cfg = RenderConfig(**KW)
    scene, _ = tsc.rtiow_final_scene(seed=3, grid=2)
    table, cam16 = k2._operands(scene, tsc.rtiow_final_camera(cfg.aspect))
    plan = cluster_scene(scene, cluster_size=5)
    n = cfg.num_pixels
    with pytest.raises(ValueError, match="needs clusters"):
        k2.record_frame(table, cam16, cfg,
                        live=torch.zeros((2, n), dtype=torch.int32))
    for bad, err in (((2, n - 1), ValueError), ((n,), ValueError)):
        with pytest.raises(err, match="shape"):
            k2.record_frame(table, cam16, cfg, clusters=plan,
                            live=torch.zeros(bad, dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        k2.record_frame_plain(table, cam16, cfg, clusters=plan,
                              live=torch.zeros((2, n)))
