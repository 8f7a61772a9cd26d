"""K1: its plain twin against the JAX package's TPU kernel (run as its own
tests run it, `interpret=True`), the twin's scheduling invariants, the
wrapper's contract.  The CUDA kernel's own tests are in test_torch_cuda.py.

Image bounds (bevy_raytrace_tpu_torch/parity.py):
  * config1 and config2 hold the tight interpret-mode bound
    (parity.INTERPRET, as tests/test_mxu.py): twin and TPU kernel run the
    same centered-quadratic arithmetic in float32 on one CPU.
  * rtiow_final is held at the bench's compiled-parity bound
    (parity.COMPILED): its defocus lens and fuzzed metal produce grazing
    bounces whose second root lands within 1e-4 of t_min, so the last-ulp
    differences between torch's and XLA's sin/cos flip about one path in
    2,000 pixels here; the TPU kernel's own tests see the same class of
    flip against the XLA wavefront.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bevy_raytrace_tpu import RenderConfig as JConfig
from bevy_raytrace_tpu import scenes as jsc
from bevy_raytrace_tpu.kernels.mxu_render import render_mxu_with_len as j_k1
from bevy_raytrace_tpu_torch import RenderConfig
from bevy_raytrace_tpu_torch import set_default_device
from bevy_raytrace_tpu_torch import scenes as tsc
from bevy_raytrace_tpu_torch.interop import (
    camera_from_reference,
    scene_from_reference,
)
from bevy_raytrace_tpu_torch.kernels import render_lanes as k1
from bevy_raytrace_tpu_torch.parity import COMPILED, INTERPRET, compare
from bevy_raytrace_tpu_torch.utils import spans
from bevy_raytrace_tpu_torch.wavefront.render import frame_seed, render

torch.set_num_threads(2)
set_default_device("cpu")  # the port defaults to the CUDA device

SCENES = {
    "config1": (lambda: jsc.baseline_config1_scene(),
                jsc.baseline_config1_camera, INTERPRET),
    "config2": (lambda: jsc.baseline_config2_scene(),
                jsc.baseline_config2_camera, INTERPRET),
    "rtiow_final": (lambda: jsc.rtiow_final_scene(seed=3, grid=2),
                    jsc.rtiow_final_camera, COMPILED),
}


def _small(name="config2", **kw):
    cfg = RenderConfig(**{**dict(width=64, height=32, samples_per_pixel=4,
                                 max_depth=4), **kw})
    builders = {"config1": (tsc.baseline_config1_scene,
                            tsc.baseline_config1_camera),
                "config2": (tsc.baseline_config2_scene,
                            tsc.baseline_config2_camera),
                "rtiow_final": (lambda: tsc.rtiow_final_scene(seed=3, grid=2),
                                tsc.rtiow_final_camera)}
    scene_fn, cam_fn = builders[name]
    return scene_fn()[0], cam_fn(cfg.aspect), cfg


@pytest.mark.parametrize("name", sorted(SCENES))
def test_twin_matches_tpu_kernel(name):
    kw = dict(width=64, height=32, samples_per_pixel=2, max_depth=4)
    build, camera, bound = SCENES[name]
    jscene, _ = build()
    jcam = camera(64 / 32)
    want_img, want_len = j_k1(jscene, jcam, JConfig(**kw), 2, interpret=True)
    before = spans.counter("k1.launches")
    got_img, got_len = k1.render_mxu_with_len(
        scene_from_reference(jscene), camera_from_reference(jcam),
        RenderConfig(**kw), 2)
    assert spans.counter("k1.launches") == before  # the twin is no launch
    stats = compare(got_img.numpy(), np.asarray(want_img), bound)
    assert stats["ok"], stats
    # Cost map: executed rounds per sample.  A flipped path changes its
    # pixel's count, so allow as many pixels as the image bound allows.
    off = np.abs(got_len.numpy() - np.asarray(want_len)) > 1e-6
    assert off.mean() <= bound.bad_frac, off.mean()


def test_random_perm_is_bit_identical():
    scene, cam, cfg = _small("rtiow_final")
    plain, plain_len = k1.render_mxu_with_len(scene, cam, cfg)
    perm = torch.from_numpy(
        np.random.default_rng(7).permutation(cfg.num_pixels).astype(np.int32))
    shuffled, shuffled_len = k1.render_mxu_with_len(scene, cam, cfg,
                                                    perm=perm)
    np.testing.assert_array_equal(shuffled.numpy(), plain.numpy())
    np.testing.assert_array_equal(shuffled_len.numpy(), plain_len.numpy())
    sorted_perm = k1.balance_perm(plain_len)
    assert sorted(sorted_perm.tolist()) == list(range(cfg.num_pixels))
    np.testing.assert_array_equal(
        k1.render_mxu(scene, cam, cfg, perm=sorted_perm).numpy(),
        plain.numpy())


def test_probe_plus_rest_equals_full_render():
    """Samples [0, p) plus samples [p, spp) (sample_base) trace exactly the
    full render's paths; only the per-pixel sum is split (1e-6)."""
    scene, cam, cfg = _small("config2", samples_per_pixel=8)
    full = k1.render_mxu(scene, cam, cfg).numpy()
    probe, _ = k1.render_mxu_with_len(scene, cam,
                                      cfg.replace(samples_per_pixel=3))
    rest, _ = k1.render_mxu_with_len(scene, cam,
                                     cfg.replace(samples_per_pixel=5),
                                     sample_base=3)
    np.testing.assert_allclose((probe * 3 + rest * 5).numpy() / 8, full,
                               atol=1e-6)
    balanced = k1.render_mxu_balanced(scene, cam, cfg, probe_spp=2).numpy()
    np.testing.assert_allclose(balanced, full, atol=1e-6)
    img, perm = k1.render_probed(scene, cam, cfg, probe_spp=8)
    np.testing.assert_array_equal(img.numpy(), full)  # probe is the frame
    assert perm.dtype == torch.int32 and perm.shape == (cfg.num_pixels,)


def _len_maps():
    """Cost maps with many equal costs, where the tie order decides the
    perm: the twin's own (rtiow at 64x32x4) and seeded quarters."""
    scene, cam, cfg = _small("rtiow_final")
    _, lmap = k1.render_mxu_with_len(scene, cam, cfg)
    rng = np.random.default_rng(11)
    seeded = (rng.integers(4, 33, (24, 40)) / 4).astype(np.float32)
    return [lmap.numpy(), seeded]


@pytest.mark.parametrize("coherent", [True, False])
def test_balance_perm_matches_reference(coherent):
    """The perm is integer work: bit for bit the reference's, for both
    orders and several quanta (equal costs sort stably without
    `coherent`, as jnp.argsort does)."""
    import jax.numpy as jnp

    from bevy_raytrace_tpu.kernels.mxu_render import balance_perm as j_perm

    for len_map in _len_maps():
        for quant in (2.0, 4.0, 0.5):
            want = np.asarray(j_perm(jnp.asarray(len_map), coherent=coherent,
                                     quant=quant))
            got = k1.balance_perm(torch.from_numpy(len_map),
                                  coherent=coherent, quant=quant)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


def test_probe_reuse_allclose():
    """tests/test_mxu.py's probe-reuse test: the reused probe renders the
    same paths, summed in two groups (allclose to the plain render); with
    probe_reuse=False the probe only sorts and the image is the plain
    render's bit for bit."""
    scene, cam, cfg = _small("config2", samples_per_pixel=8)
    plain = k1.render_mxu(scene, cam, cfg).numpy()
    reuse = k1.render_mxu_balanced(scene, cam, cfg, probe_spp=2,
                                   probe_reuse=True).numpy()
    np.testing.assert_allclose(reuse, plain, atol=1e-5)
    exact = k1.render_mxu_balanced(scene, cam, cfg, probe_spp=2,
                                   probe_reuse=False).numpy()
    np.testing.assert_array_equal(exact, plain)


def test_balanced_bit_identical():
    """tests/test_mxu.py's: cost-sorting pixels re-schedules the lanes but
    changes no bit of the image (the default probe takes every sample)."""
    scene, cam, cfg = _small("config2", width=64, height=48,
                             samples_per_pixel=4, max_depth=6)
    plain = k1.render_mxu(scene, cam, cfg).numpy()
    for reuse in (True, False):
        np.testing.assert_array_equal(
            k1.render_mxu_balanced(scene, cam, cfg,
                                   probe_reuse=reuse).numpy(), plain)


def test_twin_matches_torch_wavefront_and_counts_rounds():
    """The twin against the port's own wavefront (the oracle it is held to
    on the card), and the cost map's range: [1, max_depth], ~1 for sky."""
    scene, cam, cfg = _small("rtiow_final", width=64, height=48,
                             max_depth=8)
    img, lmap = k1.render_mxu_with_len(scene, cam, cfg)
    stats = compare(img.numpy(), render(scene, cam, cfg).numpy(), COMPILED)
    assert stats["ok"], stats
    lmap = lmap.numpy()
    assert lmap.min() >= 1.0 - 1e-6 and lmap.max() <= cfg.max_depth + 1e-6
    assert lmap[0].mean() < 1.5  # top rows are sky


def test_depth_zero_is_black():
    scene, cam, cfg = _small("config1", max_depth=0)
    img, lmap = k1.render_mxu_with_len(scene, cam, cfg)
    assert img.shape == (32, 64, 3)
    assert float(img.abs().max()) == 0.0 and float(lmap.abs().max()) == 0.0


def test_more_than_1024_spheres_render():
    """The TPU kernel rejects > 1,024 spheres (tests/test_mxu.py); K1 on
    Hopper has no cap.  1,100 small spheres over a ground plane, held
    against the wavefront."""
    rng = np.random.default_rng(0)
    n = 1100
    centers = np.concatenate([
        [[0.0, -100.5, -1.0]],
        np.c_[rng.uniform(-3, 3, n - 1), rng.uniform(-0.4, 0.6, n - 1),
              rng.uniform(-4, -1.5, n - 1)]]).astype(np.float32)
    radii = np.r_[100.0, rng.uniform(0.02, 0.08, n - 1)].astype(np.float32)
    base, _ = tsc.baseline_config2_scene()
    scene = dataclasses.replace(
        base, centers=torch.from_numpy(centers), radii=torch.from_numpy(radii),
        material_id=torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)))
    cfg = RenderConfig(width=32, height=16, samples_per_pixel=2, max_depth=3)
    cam = tsc.baseline_config1_camera(cfg.aspect)
    img, lmap = k1.render_mxu_with_len(scene, cam, cfg)
    assert torch.isfinite(img).all() and float(img.max()) > 0.0
    assert float(lmap.max()) > 1.0  # some paths bounce off the small spheres
    stats = compare(img.numpy(), render(scene, cam, cfg).numpy(), COMPILED)
    assert stats["ok"], stats


def test_wrapper_rejects_bad_operands():
    scene, cam, cfg = _small("config1")
    geom, attr = k1._scene_tables(scene)
    pids = torch.arange(256, dtype=torch.int32)
    args = (frame_seed(cfg, 0), 0, 1, 2, cfg.t_min, cfg.width, cfg.height)
    c16 = cam.pack()
    with pytest.raises(TypeError, match="int32"):
        k1.render_lanes(geom, attr, c16, pids.long(), *args)
    with pytest.raises(ValueError, match="multiple of 128"):
        k1.render_lanes(geom, attr, c16, pids[:200], *args)
    with pytest.raises(ValueError, match="shape"):
        k1.render_lanes(geom, attr[:, :7].contiguous(), c16, pids, *args)
    with pytest.raises(ValueError, match="contiguous"):
        k1.render_lanes(geom.T.contiguous().T, attr, c16, pids, *args)
    with pytest.raises(ValueError, match="on meta"):
        k1.render_lanes(geom, attr, c16, pids.to("meta"), *args)
    with pytest.raises(ValueError, match="32-bit"):
        k1.render_lanes(geom, attr, c16, pids, 2**32, *args[1:])
    fb, ln = k1.render_lanes(geom, attr, c16, pids, *args)
    assert fb.shape == (256, 3) and ln.shape == (256,)


def test_library_path_follows_its_own_flags(monkeypatch):
    """A library's path hashes its own nvcc flags: a change to its
    EXTRA_FLAGS entry builds it anew under another name, and a change to
    another library's entry leaves it where it is."""
    from bevy_raytrace_tpu_torch.kernels import build as kbuild

    k1, k3 = (kbuild.library_path(n) for n in ("k1_render", "k3_replay_grad"))
    monkeypatch.setitem(kbuild.EXTRA_FLAGS, "k3_replay_grad", ("-fmad=true",))
    assert kbuild.library_path("k3_replay_grad") not in (k1, k3)
    assert kbuild.library_path("k1_render") == k1
    monkeypatch.setitem(kbuild.EXTRA_FLAGS, "k1_render", ("-lineinfo",))
    assert kbuild.library_path("k1_render") != k1
    assert kbuild.library_path("k1_render").parent == k1.parent


def test_build_output_of_a_cached_library(tmp_path, monkeypatch):
    """build_output gives nvcc's output (ptxas's registers, stack frame and
    spills) of this process's build, else the log saved beside a library
    that an earlier process built."""
    from bevy_raytrace_tpu_torch.kernels import build as kbuild

    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kbuild, "load", lambda name: None)
    monkeypatch.setattr(kbuild, "BUILD_LOG", {})
    saved = "ptxas info    : Used 64 registers, used 1 barriers"
    kbuild.library_path("k1_render").with_suffix(".log").write_text(saved)
    assert kbuild.build_output("k1_render") == saved
    kbuild.BUILD_LOG["k1_render"] = (2.5, "this process's build")
    assert kbuild.build_output("k1_render") == "this process's build"
    with pytest.raises(FileNotFoundError):
        kbuild.build_output("k4_sweep_record")
