"""The generators: the same seed gives the same inputs, another seed other
ones, and every seed the same amount of work."""

import numpy as np
import pytest
import torch

from brtbench import scene_gen, spec, traffic

SEEDS = (2**31 + 7, 3_000_000_001)


@pytest.mark.parametrize("config", ["rtiow_final", "bevy_reference"])
def test_scene_by_seed(config):
    conf = spec.load_cell(f"{config}.render").config
    a = scene_gen.build(conf["scene"], SEEDS[0], "cpu")
    b = scene_gen.build(conf["scene"], SEEDS[0], "cpu")
    c = scene_gen.build(conf["scene"], SEEDS[1], "cpu")
    for f in ("centers", "radii", "kind", "albedo", "fuzz", "ior"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    # Colours follow the seed; the layout, and so the work, does not.
    assert not torch.equal(a.albedo, c.albedo)
    for f in ("centers", "radii", "kind", "fuzz", "ior"):
        assert torch.equal(getattr(a, f), getattr(c, f))
    other = dict(conf["scene"], layout_seed=1)
    d = scene_gen.build(other, SEEDS[0], "cpu")
    assert not torch.equal(a.centers, d.centers)
    assert not torch.equal(a.kind, d.kind)
    # Another layout has the same count of spheres and of each kind.
    assert a.count == d.count
    assert torch.equal(torch.bincount(a.kind, minlength=3),
                       torch.bincount(d.kind, minlength=3))
    grid = conf["scene"]["grid"]
    ko = torch.tensor(grid["keep_out"]["center"])
    g = a.centers[1:-len(conf["scene"]["heroes"])]
    assert (torch.linalg.norm(g - ko, dim=1) > grid["keep_out"]["distance"]
            ).all()


def test_sphere_counts():
    for cell, n in (("rtiow_final.render", 488),
                    ("bevy_reference.render", 200)):
        conf = spec.load_cell(cell).config
        assert scene_gen.build(conf["scene"], 5, "cpu").count == n
    assert scene_gen.grid_kind_counts(484, {"lambertian": 0.8,
                                            "metallic": 0.15,
                                            "dielectric": 0.05}) == [387, 73,
                                                                     24]


def test_fixed_camera_is_the_configuration_pose():
    cell = spec.load_cell("rtiow_final.render")
    f, a = traffic.CameraPath(cell.traffic, cell.config, 5).poses([0, 9])
    assert np.array_equal(f, [[13, 2, 3]] * 2)
    assert np.array_equal(a, [[0, 0, 0]] * 2)


def test_fly_path_by_seed():
    cell = spec.load_cell("bevy_reference.realtime")
    frames = np.arange(0, 2000)
    p0 = traffic.CameraPath(cell.traffic, cell.config, SEEDS[0])
    p1 = traffic.CameraPath(cell.traffic, cell.config, SEEDS[0])
    p2 = traffic.CameraPath(cell.traffic, cell.config, SEEDS[1])
    f0, a0 = p0.poses(frames)
    f1, a1 = p1.poses(frames)
    f2, _ = p2.poses(frames)
    assert np.array_equal(f0, f1) and np.array_equal(a0, a1)
    assert not np.allclose(f0, f2)
    # 10 units/s over 1/60 s a frame, on the circle through the start pose.
    step = np.linalg.norm(np.diff(f0[:, [0, 2]], axis=0), axis=1)
    assert np.allclose(step, 10 / 60, rtol=1e-3)
    r = np.hypot(f0[:, 0], f0[:, 2])
    assert np.allclose(r, np.hypot(13, 3))
    # Every seed flies the same loop: the look-at stays near the target.
    d = np.linalg.norm(a0, axis=1)
    assert d.max() < 3.0


def test_checked_pixels_and_reservoir_by_seed():
    a = traffic.checked_pixels(SEEDS[0], 5, 1000, 50)
    assert np.array_equal(a, traffic.checked_pixels(SEEDS[0], 5, 1000, 50))
    assert not np.array_equal(a, traffic.checked_pixels(SEEDS[1], 5, 1000,
                                                        50))
    assert not np.array_equal(a, traffic.checked_pixels(SEEDS[0], 6, 1000,
                                                        50))
    assert len(set(a.tolist())) == 50 and a.max() < 1000

    def sample(seed):
        r = traffic.Reservoir(4, seed)
        for i in range(100_000):
            r.offer(i)
        return sorted(r.items)

    assert sample(SEEDS[0]) == sample(SEEDS[0])
    assert sample(SEEDS[0]) != sample(SEEDS[1])
    # Uniform: over many seeds each item is kept with chance size / n.
    counts = np.zeros(10)
    for seed in range(2000):
        r = traffic.Reservoir(2, seed)
        for i in range(10):
            r.offer(i)
        for i in r.items:
            counts[i] += 1
    assert np.allclose(counts / 2000, 0.2, atol=0.04)
