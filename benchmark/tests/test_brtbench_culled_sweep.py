"""The culled sweep's count (brtbench/yardstick/culled_sweep.py) against the
plain reference's paths and the brute-force count, and its reader."""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from brtbench import reference, scene_flake, spec, traffic
from brtbench.yardstick import culled_sweep, forward_sweep

SEED = 2**31 + 11


def _flake(level=2):
    conf = spec.load_cell("sphereflake.render_culled").config
    block = dict(conf["scene"])
    block["flake"] = dict(block["flake"], level=level)
    return conf, scene_flake.build(block, SEED, "cpu")


def _paths(conf, arrays, n_pix=64, spp=3, depth=8, width=40, height=40):
    cam = conf["camera"]
    cams = reference.look_at(
        torch.tensor([cam["lookfrom"]], dtype=torch.float32),
        torch.tensor([cam["lookat"]], dtype=torch.float32), cam["vup"],
        cam["vfov_deg"], width / height, cam["aperture"], cam["focus_dist"])
    pids = torch.from_numpy(traffic.checked_pixels(SEED, 0, width * height,
                                                   n_pix))
    seeds = torch.full(pids.shape, reference.frame_seed(SEED, 0),
                       dtype=torch.int64)
    return (arrays, cams.expand(n_pix, 16), pids, seeds, spp, depth, width,
            height)


def test_plan_is_the_ports_cluster_scene():
    """The yardstick's frozen plan rule is the port's cluster_scene of
    today: the same order, chunk by chunk."""
    from bevy_raytrace_tpu_torch.core.types import make_scene
    from bevy_raytrace_tpu_torch.kernels.clusters import cluster_scene

    _, a = _flake(3)
    scene = make_scene(a.centers, a.radii, a.material_id, a.albedo, a.kind,
                       a.fuzz, a.ior, device="cpu")
    order = culled_sweep.plan_order(a.centers.numpy())
    assert np.array_equal(order, cluster_scene(scene, 12).perm[:a.count])


@pytest.mark.parametrize("size", [1, 4, 12])
def test_count_follows_the_references_paths(size):
    """The rounds are the reference's own; the members swept never exceed
    the brute-force sweep's spheres, round by round summed, and some
    chunks are passed by; so the culled count, less its bound tests, never
    exceeds forward_sweep's."""
    conf, arrays = _flake()
    args = _paths(conf, arrays)
    _, want_rounds = reference.render_pixels(*args)
    rounds, members = culled_sweep.count_paths(*args, size)
    assert torch.equal(rounds, want_rounds)
    assert bool((members <= rounds.double() * arrays.count).all())
    assert float(members.sum()) < 0.9 * float(rounds.sum()) * arrays.count
    n_chunks = -(-arrays.count // size)
    flops, _ = culled_sweep.culled_work(
        arrays.count, n_chunks, 64, 3, float(rounds.sum()),
        float(members.sum()))
    brute, _ = forward_sweep.forward_work(
        "k1", arrays.count, 64, 3, 8, float(rounds.sum()))
    tests = float(rounds.sum()) * n_chunks * forward_sweep.SWEEP_FLOPS
    assert flops - tests <= brute


def test_count_at_cluster_size_1_with_every_chunk_live_is_brute_force():
    """Nested spheres about the eye, camera rays: every segment starts
    inside every bound, so at cluster size 1 every chunk is entered, the
    members swept are the brute-force sweep's spheres, and the count less
    its bound tests is forward_sweep's."""
    conf, arrays = _flake(1)
    n = 6
    arrays.centers = torch.tensor([conf["camera"]["lookfrom"]] * n,
                                  dtype=torch.float32)
    arrays.radii = torch.linspace(1.0, 3.0, n)
    args = _paths(conf, reference.SceneArrays(
        arrays.centers, arrays.radii, arrays.material_id[:n],
        arrays.albedo, arrays.kind, arrays.fuzz, arrays.ior), depth=1)
    rounds, members = culled_sweep.count_paths(*args, 1)
    assert torch.equal(members, rounds.double() * n)
    total = float(rounds.sum())
    flops, _ = culled_sweep.culled_work(n, n, 64, 3, total, total * n)
    brute, _ = forward_sweep.forward_work("k1", n, 64, 3, 1, total)
    assert total == 64 * 3
    assert flops - total * n * forward_sweep.SWEEP_FLOPS == brute


def test_culled_roofline_reader_hand_worked():
    trace = types.SimpleNamespace(
        window_s=2.0, busy_s=1.0,
        kernel_seconds=lambda frag: ((2e-3, 4) if frag == "k1_culled_kernel"
                                     else (0.0, 0)))
    rec = types.SimpleNamespace(
        trace=trace, paths_per_frame=100 * 4, n_spheres=30, n_pix=100,
        spp=4, culled_chunks=3, culled_rounds_per_path=2.5,
        culled_members_per_path=20.0)
    flops = (2.5 * 400 * (3 * 16 + 120) + 20.0 * 400 * 16 + 400 * 70)
    nbytes = 30 * 48 + 3 * 16 + 64 + 100 * 12 + 100 * 8
    least = max(flops / 67e12, nbytes / 3.35e12)
    read = spec.reader("k1_culled_roofline_pct")
    assert read(rec) == pytest.approx(100 * least * 4 / 2e-3)
    rec.culled_members_per_path = None  # a run with no count
    assert read(rec) is None
    rec.culled_members_per_path = 20.0
    rec.trace = types.SimpleNamespace(kernel_seconds=lambda frag: (0.0, 0))
    assert read(rec) is None  # no culled launch: a session that is dense
    rec.trace = None
    assert read(rec) is None


def test_configuration_block_is_the_flake():
    conf = json.loads((spec.BENCH_DIR / "configs" / "sphereflake.json"
                       ).read_text())
    a = scene_flake.build(conf["scene"], SEED, "cpu")
    assert a.count == 1 + 7381 and float(a.radii[0]) == 1000.0
    assert float(a.radii[1:].min()) == pytest.approx(0.5 / 81, rel=1e-6)


@pytest.mark.parametrize("change,match", [
    ({"cluster_size": 6}, "cluster_size 12"),
    ({"cluster_size": None}, "cluster_size 12"),
    ({"clients": 4}, "clients"),
], ids=["size", "none", "key"])
def test_session_culled_refuses_a_mix_it_cannot_run(change, match):
    """The runner's session culls at its CLUSTER_SIZE: a mix that asks for
    another, or for traffic it does not send, is refused before a run."""
    runner = spec.runner("session_culled")
    cell = spec.load_cell("sphereflake.render_culled")
    runner.validate(cell)
    bad = dataclasses.replace(cell, traffic=dict(cell.traffic, **change))
    with pytest.raises(ValueError, match=match):
        runner.validate(bad)


class _Launches:
    """A session whose every frame counts `dense` and `culled` K1 launches
    on the port's counters, as the kernels' wrapper does."""

    def __init__(self, dense, culled):
        self.dense, self.culled, self.frames = dense, culled, 0

    def render_frame(self, scene, camera):
        from bevy_raytrace_tpu_torch.utils.spans import count

        count("k1.launches", self.dense + self.culled)
        if self.culled:
            count("k1.launches_culled", self.culled)
        self.frames += 1
        return self.frames


@pytest.mark.parametrize("dense,culled,refused", [
    (0, 2, False), (2, 0, True), (1, 1, True), (0, 0, True),
], ids=["culled", "dense", "mixed", "none"])
def test_session_culled_refuses_a_session_that_does_not_cull(dense, culled,
                                                             refused):
    """The runner's card session is held to the culled K1 on its first
    frame: a session that launches K1 dense there, or not at all, is
    refused before the window; one that culls runs on unchecked."""
    session = spec.runner("session_culled")._Culls(_Launches(dense, culled))
    if refused:
        with pytest.raises(RuntimeError, match="does not cull"):
            session.render_frame(None, None)
        return
    assert [session.render_frame(None, None) for _ in range(3)] == [1, 2, 3]
