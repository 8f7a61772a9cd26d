"""K1's and K4's table modes and their lane schedules, on the host.

The size rule that stages the sphere rows in shared memory or reads them
from device memory (`kernels/common.py::forward_table_plan`, a pure function
of the row count and the limit a kernel's library reports), the wrappers'
refusal of a mode they do not know, and `tools/forward_kernels.py`'s
lane-efficiency helper: the share of lane-rounds that do work when every
lane of a warp waits for the warp's longest path of each sample (the nested
schedule) and when a lane waits only for the warp's longest total (the
per-lane refill K1 and K4 run).  The kernels' two modes run only on a card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from bevy_raytrace_tpu_torch import RenderConfig
from bevy_raytrace_tpu_torch import set_default_device
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch.kernels import common
from bevy_raytrace_tpu_torch.kernels import record as k2
from bevy_raytrace_tpu_torch.kernels import render_lanes as k1
from bevy_raytrace_tpu_torch.kernels import sweep_record as k4
from bevy_raytrace_tpu_torch.tools.forward_kernels import (
    lane_rounds,
    schedule_efficiency,
)
from bevy_raytrace_tpu_torch.wavefront.render import frame_seed

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

# An H100's per-block opt-in shared memory (232,448 bytes; K1 and K4 have no
# static shared memory): the most any limit query can return there.
H100_OPTIN = 232_448
LAST_FIT = H100_OPTIN // common.FORWARD_ROW_BYTES  # 14,528 rows


@pytest.mark.parametrize("n_rows,limit,mode", [
    (0, H100_OPTIN, "shared"), (1, H100_OPTIN, "shared"),
    (486, H100_OPTIN, "shared"), (LAST_FIT, H100_OPTIN, "shared"),
    (LAST_FIT + 1, H100_OPTIN, "global"), (15000, H100_OPTIN, "global"),
    (2000, 2000 * 16, "shared"), (2001, 2000 * 16, "global"),
    (1, 0, "global"), (1, 15, "global"), (1, 16, "shared")])
def test_forward_table_plan_at_its_boundaries(n_rows, limit, mode):
    got, nbytes = common.forward_table_plan(n_rows, limit)
    assert got == mode
    assert nbytes == (n_rows * 16 if mode == "shared" else 0)
    assert nbytes <= limit


def test_forward_table_plan_rejects_negative_sizes():
    with pytest.raises(ValueError, match="n_rows"):
        common.forward_table_plan(-1, H100_OPTIN)
    with pytest.raises(ValueError, match="limit_bytes"):
        common.forward_table_plan(3, -1)


def _k1_operands(cfg):
    scene, _ = tsc.baseline_config2_scene()
    cam = tsc.baseline_config2_camera(cfg.aspect)
    geom, attr = k1._scene_tables(scene)
    pids = torch.arange(k1.lane_pad(cfg.num_pixels), dtype=torch.int32)
    return geom, attr, cam.pack().contiguous(), pids


@pytest.mark.parametrize("mode", ["texture", "SHARED", 1, ""])
def test_wrappers_reject_an_unknown_table_mode(mode):
    """The mode is checked before any operand, on every device."""
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1, max_depth=2)
    geom, attr, cam16, pids = _k1_operands(cfg)
    with pytest.raises(ValueError, match="table_mode"):
        k1.render_lanes(geom, attr, cam16, pids, 0, 0, 1, 2, cfg.t_min,
                        cfg.width, cfg.height, table_mode=mode)
    scene, _ = tsc.baseline_config2_scene()
    table, cam16 = k2._operands(scene, tsc.baseline_config2_camera(
        cfg.aspect))
    with pytest.raises(ValueError, match="table_mode"):
        k4.sweep_record_frame(table, cam16, cfg, table_mode=mode)


@pytest.mark.parametrize("mode", [None, "shared", "global"])
def test_cpu_twins_take_every_known_mode(mode):
    """On CPU tensors a known mode is accepted and the twin runs: the mode
    selects where the kernel reads its rows, never what it computes."""
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=2, max_depth=3)
    geom, attr, cam16, pids = _k1_operands(cfg)
    args = (geom, attr, cam16, pids, 5, 0, 2, 3, cfg.t_min, cfg.width,
            cfg.height)
    fb, ln = k1.render_lanes(*args, table_mode=mode)
    want_fb, want_ln = k1.render_lanes_plain(*args)
    assert torch.equal(fb, want_fb) and torch.equal(ln, want_ln)
    scene, _ = tsc.baseline_config2_scene()
    table, c16 = k2._operands(scene, tsc.baseline_config2_camera(cfg.aspect))
    img, res, _ = k4.sweep_record_frame(table, c16, cfg, table_mode=mode)
    want_img, want_res, _ = k4.sweep_record_frame_plain(table, c16, cfg)
    assert torch.equal(img, want_img) and torch.equal(res, want_res)


# --- the lane-efficiency helper -------------------------------------------


@pytest.mark.parametrize("spp,lanes,value", [(1, 32, 1.0), (4, 64, 3.0),
                                             (16, 128, 2.0)])
def test_equal_path_lengths_waste_nothing(spp, lanes, value):
    eff = schedule_efficiency(torch.full((spp, lanes), value))
    assert eff["nested"] == 1.0 and eff["refill"] == 1.0
    assert eff["work"] == spp * lanes * value


def test_one_long_lane_gives_its_exact_fraction():
    """Every lane of one warp runs 1 round a sample, lane 0 runs 5 in sample
    0 and lane 1 runs 5 in sample 1.  Nested: the warp runs 5 rounds per
    sample, 10 in all, for 72 lane-rounds of work: 72 / 320.  Refill: the
    longest lane total is 6 rounds: 72 / 192."""
    r = torch.ones((2, 32))
    r[0, 0] = r[1, 1] = 5.0
    eff = schedule_efficiency(r)
    assert eff["work"] == 72.0
    assert eff["nested_slots"] == 320.0 and eff["refill_slots"] == 192.0
    assert eff["nested"] == 72 / 320 and eff["refill"] == 72 / 192


def test_no_work_and_unaligned_lanes():
    assert schedule_efficiency(torch.zeros((3, 64)))["nested"] == 1.0
    assert schedule_efficiency(torch.zeros((0, 32)))["refill"] == 1.0
    with pytest.raises(ValueError, match="multiple of 32"):
        schedule_efficiency(torch.ones((2, 48)))


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 6), st.integers(1, 3), st.integers(0, 2**31 - 1))
def test_refill_never_wastes_more_than_nested(spp, warps, seed):
    """The longest lane total of a warp is at most the sum of its per-sample
    maxima, so the refill's efficiency is never below the nested one's, and
    neither passes 1."""
    r = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 9, (spp, 32 * warps)).astype(np.float32))
    eff = schedule_efficiency(r)
    assert eff["nested"] <= eff["refill"] + 1e-12
    assert 0.0 < eff["nested"] <= 1.0 and eff["refill"] <= 1.0


def test_per_sample_launches_read_what_k1_counts():
    """Through K1's twin on rtiow at 32x16, depth 8: the rounds of the
    spp=1 launches (one per sample, through sample_base) sum exactly to the
    full launch's `len`, lane by lane."""
    cfg = RenderConfig(width=32, height=16, samples_per_pixel=4, max_depth=8)
    scene, _ = tsc.rtiow_final_scene(seed=3, grid=2)
    cam = tsc.rtiow_final_camera(cfg.aspect)
    geom, attr = k1._scene_tables(scene)
    pids = torch.arange(k1.lane_pad(cfg.num_pixels), dtype=torch.int32)
    args = (geom, attr, cam.pack().contiguous(), pids, frame_seed(cfg, 1), 7,
            cfg.samples_per_pixel, cfg.max_depth, cfg.t_min, cfg.width,
            cfg.height)
    rounds = lane_rounds(*args)
    assert rounds.shape == (cfg.samples_per_pixel, pids.numel())
    _, full = k1.render_lanes(*args)
    assert torch.equal(rounds.sum(0), full)
    assert float(rounds.max()) == cfg.max_depth  # some path runs to the end
    eff = schedule_efficiency(rounds)
    assert eff["work"] == float(full.sum())
    assert 0.0 < eff["nested"] <= eff["refill"] <= 1.0
