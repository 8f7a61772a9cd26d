#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths from a checkout of this repository — the
forward render of a frame through the K1 CUDA kernel, and inverse rendering
through the K2 (recording forward) and K3 (replay gradient) CUDA kernels —
and fails loudly — a traceback and a nonzero exit — if any phase fails:

  1. environment: torch/CUDA versions, the card (nvidia-smi), nvcc;
  2. build: K1 from bevy_raytrace_tpu_torch/csrc with nvcc, timed;
  3. parity at the bench's verify config (240x160, 8 spp, depth 8) on
     rtiow_final and baseline_config2: kernel vs its plain PyTorch twin and
     vs the torch wavefront under parity.COMPILED; a random lane
     permutation must give a bit-identical kernel image;
  4. the reference's own frame (1920x1080, depth 3, reference_scene, 64 spp)
     through Renderer(backend="cuda"): a probe frame, then cached-perm
     frames; finite, and one 16,384-pixel stripe against the twin;
  5. the flagship (1200x800, 256 spp, depth 8, rtiow_final) through
     render_mxu_balanced, timed;
  6. K1's launch count over phases 4-5 must be > 0;
  7. build: K2 (k2_record) and K3 (k3_replay_grad), one nvcc each, started
     together, timed, with ptxas registers and spills;
  8. K2 against its plain twin at the gradient bench's shape (400x300,
     16 spp, depth 8, rtiow_final, edge_softness 0.01): image under
     parity.COMPILED, at most 2% of residual entries differing, and the
     torch replay of the kernel's residuals reconstructing its image;
  9. K3 against its plain twin (autograd of the torch replay) on those
     residuals with a seeded cotangent: d_table and d_cam to rtol 2e-3 of
     each array's max-abs.  Then every other instantiation the main path
     launches, each against its twin on the same inputs: at the bench's
     shape with edge_softness 0, K2 recording winners only and value only,
     and K3 without the silhouette term; and on a 2-sample slice of the
     flagship gradient (1200x800, samples 128-129 through sample_base), the
     same three;
 10. inverse rendering at the CLI's size (1200x800, 64 spp, depth 8,
     edge_softness 0.01, config1 perturbed as `cli inverse` does): 3 Adam
     steps with a checkpoint, resumed to 6 steps, and the step-3 checkpoint
     resumed again for the same 3 steps; finite losses, the last below the
     first, the two resumed runs agreeing;
 11. the flagship gradient (1200x800, 256 spp, depth 8, rtiow_final, d
     mean(img^2) / d centers) unchunked and with grad_spp_chunk=64; finite
     and agreeing to rtol 2e-3;
 12. K2's and K3's launch counts over phases 10-11 must be > 0.

Kernel times are CUDA-event times; step times are host-clock times to
torch.cuda.synchronize().  Prints a {"kernels": [...]} line, the
card's name and power limit, and last {"ok": true, "device": {...}}.
Exits nonzero without a result when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, reps, warm=True):
    """Mean CUDA-event milliseconds of fn() over `reps` runs (after one
    warm-up run if `warm`) and fn()'s last result."""
    import torch

    out = fn() if warm else None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def gradient_phases(dev, smi):
    """Phases 7-12: K2 and K3, and the inverse-rendering path through them.
    Returns (the kernels' JSON entries, extra stats)."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from bevy_raytrace_tpu_torch import RenderConfig
    from bevy_raytrace_tpu_torch import scenes
    from bevy_raytrace_tpu_torch.inverse import (
        make_fast_renderer,
        optimize,
        replay_image,
    )
    from bevy_raytrace_tpu_torch.kernels import build
    from bevy_raytrace_tpu_torch.kernels import record as k2
    from bevy_raytrace_tpu_torch.kernels import replay_grad as k3
    from bevy_raytrace_tpu_torch.parity import COMPILED, compare, grad_close
    from bevy_raytrace_tpu_torch.profile_grad import cli_inverse_problem

    # ---- 7. build K2 and K3 ----------------------------------------------
    names = ["k2_record", "k3_replay_grad"]
    t0 = time.perf_counter()
    build.load_all(names)
    build_s = time.perf_counter() - t0
    for name in names:
        secs, out = build.BUILD_LOG.get(name, (0.0, ""))
        log(f"[build] {name}: nvcc {secs:.2f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] k2 + k3 in {build_s:.2f} s (in parallel)")

    # ---- 8-9. K2 and K3 against their twins --------------------------------
    checks = {"k2": [], "k3": []}

    def k2_check(label, table, cam16, cfg, sample_base=0, with_residuals=True,
                 record_second=False):
        """K2 vs its twin on one input: image under COMPILED, at most 2% of
        residual entries differing.  Returns the kernel's outputs."""
        kw = dict(sample_base=sample_base, with_residuals=with_residuals,
                  record_second=record_second)
        ms, (img, res, res2) = cuda_ms(
            lambda: k2.record_frame(table, cam16, cfg, 1, **kw), 3)
        plain_ms, (pimg, pres, pres2) = cuda_ms(
            lambda: k2.record_frame_plain(table, cam16, cfg, 1, **kw), 1,
            warm=False)
        img_vs = compare(img.cpu().numpy(), pimg.cpu().numpy(), COMPILED)
        off = [float((a != b).float().mean())
               for a, b in ((res, pres), (res2, pres2)) if a is not None]
        log(f"[k2] {label}: kernel {ms:.3f} ms, twin {plain_ms:.1f} ms; "
            f"image vs twin {img_vs}; residuals differing: "
            f"{[f'{o:.5%}' for o in off]}")
        check(img_vs["ok"], f"K2 {label}: image vs twin {img_vs}")
        check(all(o <= 0.02 for o in off),
              f"K2 {label}: residuals differ from the twin's on {off}")
        check(res is None or res.dtype == torch.int16,
              "residuals are not int16")
        checks["k2"].append({"shape": label, "max_abs_err":
                             img_vs["max_abs_err"], "residuals_off": off,
                             "ms": ms, "plain_ms": plain_ms})
        return img, res, res2

    def k3_check(label, table, cam16, cfg, res, res2, sample_base=0):
        """K3 vs its twin on K2's residuals with a seeded cotangent: d_table
        and d_cam to rtol 2e-3 of the larger max-abs."""
        g = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (cfg.height, cfg.width, 3)).astype(np.float32)).to(dev)
        ms, (d_tbl, d_cam) = cuda_ms(
            lambda: k3.replay_grad(table, cam16, cfg, res, g, 1, sample_base,
                                   res2=res2), 3)
        plain_ms, (p_tbl, p_cam) = cuda_ms(
            lambda: k3.replay_grad_plain(table, cam16, cfg, res, g, 1,
                                         sample_base, res2=res2), 1,
            warm=False)
        glob = max(float(p_tbl.abs().max()), float(p_cam.abs().max()))
        tbl_vs = grad_close(d_tbl.cpu(), p_tbl.cpu(), glob=glob)
        cam_vs = grad_close(d_cam.cpu(), p_cam.cpu(), glob=glob)
        log(f"[k3] {label}: kernel {ms:.3f} ms, twin {plain_ms:.1f} ms; "
            f"d_table vs twin {tbl_vs}, d_cam vs twin {cam_vs}")
        check(tbl_vs["ok"] and cam_vs["ok"],
              f"K3 {label}: cotangents disagree with the twin's (rtol 2e-3)")
        checks["k3"].append({
            "shape": label, "rel_err": [tbl_vs["rel_err"], cam_vs["rel_err"]],
            "max_abs_err": max(tbl_vs["max_abs_err"], cam_vs["max_abs_err"]),
            "ms": ms, "plain_ms": plain_ms})

    # The gradient bench's shape (400x300, 16 spp, depth 8, rtiow_final),
    # with edge_softness 0.01 (the inverse path's instantiations: runner-up
    # recorded, the silhouette adjoint) and 0 (the flagship gradient's).
    cfg = RenderConfig(width=400, height=300, samples_per_pixel=16,
                       max_depth=8, edge_softness=0.01)
    cfg0 = cfg.replace(edge_softness=0.0)
    scene = scenes.rtiow_final_scene(0, device=dev)[0]
    cam = scenes.rtiow_final_camera(cfg.aspect, device=dev)
    table, cam16 = k2._operands(scene, cam)
    bench = f"rtiow {cfg.width}x{cfg.height}x{cfg.samples_per_pixel} depth 8"
    img, res, res2 = k2_check(f"{bench} record_second", table, cam16, cfg,
                              record_second=True)
    with torch.no_grad():
        rep = replay_image(scene, cam, cfg, res, 1, res2=res2)
    rep_vs = compare(rep.cpu().numpy(), img.cpu().numpy(), COMPILED)
    log(f"[k2] torch replay of the kernel's residuals vs its image {rep_vs}")
    check(rep_vs["ok"], f"replay does not reconstruct the K2 image {rep_vs}")
    k3_check(f"{bench} edge 0.01", table, cam16, cfg, res, res2)
    del res, res2
    _, res, _ = k2_check(f"{bench} record", table, cam16, cfg0)
    k2_check(f"{bench} value only", table, cam16, cfg0, with_residuals=False)
    k3_check(f"{bench} edge 0", table, cam16, cfg0, res, None)
    del res

    # A 2-sample slice of the flagship gradient (1200x800, samples 128-129
    # through sample_base, as grad_spp_chunk's re-recording runs them).
    sl = RenderConfig(width=1200, height=800, samples_per_pixel=2,
                      max_depth=8)
    sl_table, sl_cam16 = k2._operands(
        scene, scenes.rtiow_final_camera(sl.aspect, device=dev))
    label = "rtiow 1200x800 samples 128-129 depth 8"
    _, res, _ = k2_check(f"{label} record", sl_table, sl_cam16, sl, 128)
    k2_check(f"{label} value only", sl_table, sl_cam16, sl, 128,
             with_residuals=False)
    k3_check(f"{label} edge 0", sl_table, sl_cam16, sl, res, None, 128)
    del res

    # ---- 10. inverse rendering at the CLI's size --------------------------
    k2.record_frame.launches = 0
    k3.replay_grad.launches = 0
    scene_bad, scene_true, problem = cli_inverse_problem(dev)
    inv_cfg = problem.config
    with tempfile.TemporaryDirectory() as tmp:
        ck, ck3 = os.path.join(tmp, "inverse.npz"), os.path.join(tmp, "s3.npz")
        t0 = time.perf_counter()
        first = optimize(scene_bad, problem, steps=3, learning_rate=1.5e-2,
                         checkpoint_path=ck, checkpoint_every=3)
        shutil.copy(ck, ck3)
        rest = optimize(scene_bad, problem, steps=6, learning_rate=1.5e-2,
                        checkpoint_path=ck, checkpoint_every=3)
        torch.cuda.synchronize()
        inv_s = time.perf_counter() - t0
        again = optimize(scene_bad, problem, steps=6, learning_rate=1.5e-2,
                         checkpoint_path=ck3, checkpoint_every=100)
    losses = first.losses + rest.losses
    step_s = inv_s / len(losses)
    inv_pps = 2 * inv_cfg.rays_per_frame / step_s
    log(f"[inverse] {inv_cfg.width}x{inv_cfg.height}x"
        f"{inv_cfg.samples_per_pixel} depth {inv_cfg.max_depth}, config1: "
        f"losses {[f'{v:.6f}' for v in losses]}; resumed from step 3 again: "
        f"{[f'{v:.6f}' for v in again.losses]}; {step_s:.3f} s/step, "
        f"{inv_pps / 1e6:.1f}M paths/s (2 renders per step) on {smi}")
    log(f"[inverse] center {rest.scene.centers[1].tolist()} (true "
        f"{scene_true.centers[1].tolist()}), albedo "
        f"{rest.scene.materials.albedo[1].tolist()} (true "
        f"{scene_true.materials.albedo[1].tolist()})")
    check(len(losses) == 6 and all(np.isfinite(losses)),
          f"inverse losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(np.allclose(again.losses, rest.losses, rtol=1e-2, atol=1e-7),
          f"resuming the step-3 checkpoint twice disagrees: {rest.losses} "
          f"vs {again.losses}")

    # ---- 11. the flagship gradient ----------------------------------------
    big = RenderConfig(width=1200, height=800, samples_per_pixel=256,
                       max_depth=8)
    cam_big = scenes.rtiow_final_camera(big.aspect, device=dev)

    def flagship_grad(render_fn):
        c = scene.centers.clone().requires_grad_(True)
        loss = torch.mean(render_fn(dataclasses.replace(scene, centers=c),
                                    cam_big, 1) ** 2)
        (grad,) = torch.autograd.grad(loss, c)
        return grad

    flag = {}
    for label, chunk in (("unchunked", 0), ("chunk64", 64)):
        render_fn = make_fast_renderer(big, grad_spp_chunk=chunk)
        flagship_grad(render_fn)  # warm-up: allocations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grad = flagship_grad(render_fn)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        flag[label] = (grad, secs, big.rays_per_frame / secs)
        log(f"[flagship grad] {label}: {secs:.3f} s/step, "
            f"{big.rays_per_frame / secs / 1e6:.1f}M paths/s fwd+bwd "
            f"(1200x800x256 depth 8, {scene.count} spheres) on {smi}")
    (g_full, _, _), (g_chunk, _, _) = flag["unchunked"], flag["chunk64"]
    check(bool(torch.isfinite(g_full).all()), "flagship gradient not finite")
    fl_vs = grad_close(g_chunk.cpu(), g_full.cpu())
    log(f"[flagship grad] chunked vs unchunked {fl_vs}")
    check(fl_vs["ok"], "chunked flagship gradient disagrees with the unchunked")

    # ---- 12. launches -----------------------------------------------------
    k2_launches = k2.record_frame.launches
    k3_launches = k3.replay_grad.launches
    log(f"[launches] k2_record launches={k2_launches}, k3_replay_grad "
        f"launches={k3_launches} over phases 10-11")
    check(k2_launches > 0 and k3_launches > 0,
          "K2 or K3 was not launched by the inverse-rendering path")

    def entry(name, source, replaces, launches, ks):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in ks),
                "ms": ks[0]["ms"], "plain_ms": ks[0]["plain_ms"],
                "checks": ks}

    entries = [
        entry("k2_record", "bevy_raytrace_tpu_torch/csrc/k2_record.cu",
              "bevy_raytrace_tpu/kernels/pallas_render.py:123", k2_launches,
              checks["k2"]),
        entry("k3_replay_grad",
              "bevy_raytrace_tpu_torch/csrc/k3_replay_grad.cu",
              "bevy_raytrace_tpu/kernels/replay_grad.py:74", k3_launches,
              checks["k3"]),
    ]
    stats = {"grad_build_s": build_s, "inverse_losses": losses,
             "inverse_s_per_step": step_s, "inverse_paths_per_s": inv_pps,
             "flagship_grad_s": {k: v[1] for k, v in flag.items()},
             "flagship_grad_paths_per_s": {k: v[2] for k, v in flag.items()}}
    return entries, stats


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    from bevy_raytrace_tpu_torch import RenderConfig
    from bevy_raytrace_tpu_torch import scenes
    from bevy_raytrace_tpu_torch.kernels import build
    from bevy_raytrace_tpu_torch.kernels import render_lanes as k1
    from bevy_raytrace_tpu_torch.parity import COMPILED, compare
    from bevy_raytrace_tpu_torch.profile_grad import smi_line
    from bevy_raytrace_tpu_torch.wavefront.engine import Renderer
    from bevy_raytrace_tpu_torch.wavefront.render import frame_seed, render

    # The torch wavefront is the oracle: keep its matmuls in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. environment -------------------------------------------------
    smi = smi_line()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    log(f"[env] {smi}")
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60)
    log("[env] nvcc " + nvcc.stdout.strip().splitlines()[-1])

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    build.load("k1_render")
    build_s = time.perf_counter() - t0
    log(f"[build] k1_render in {build_s:.2f} s "
        f"(nvcc {build.BUILD_LOG.get('k1_render', (0.0,))[0]:.2f} s)")
    for line in build.BUILD_LOG.get("k1_render", (0, ""))[1].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    def lane_args(scene, cam, cfg, pids, frame=0):
        geom, attr = k1._scene_tables(scene)
        return (geom, attr, cam.pack().contiguous(), pids,
                frame_seed(cfg, frame), 0, cfg.samples_per_pixel,
                cfg.max_depth, cfg.t_min, cfg.width, cfg.height)

    def image(fb, cfg):
        return (fb[:cfg.num_pixels] / cfg.samples_per_pixel).reshape(
            cfg.height, cfg.width, 3).cpu().numpy()

    # ---- 3. parity at the verify config ---------------------------------
    verify = RenderConfig(width=240, height=160, samples_per_pixel=8,
                          max_depth=8)
    verify_times = {}
    for name, scene_fn, cam_fn in [
            ("rtiow_final", scenes.rtiow_final_scene, scenes.rtiow_final_camera),
            ("baseline_config2", scenes.baseline_config2_scene,
             scenes.baseline_config2_camera)]:
        scene = scene_fn(device=dev)[0]
        cam = cam_fn(verify.aspect, device=dev)
        pids = torch.arange(k1.lane_pad(verify.num_pixels), dtype=torch.int32,
                            device=dev)
        args = lane_args(scene, cam, verify, pids)
        kern_ms, (fb, _) = cuda_ms(lambda: k1.render_lanes(*args), 5)
        plain_ms, (fb_plain, _) = cuda_ms(
            lambda: k1.render_lanes_plain(*args), 1, warm=False)
        wave = render(scene, cam, verify).cpu().numpy()
        kimg = image(fb, verify)
        vs_twin = compare(kimg, image(fb_plain, verify), COMPILED)
        vs_wave = compare(kimg, wave, COMPILED)
        log(f"[verify] {name}: kernel {kern_ms:.3f} ms, twin {plain_ms:.1f} ms; "
            f"vs twin {vs_twin}; vs wavefront {vs_wave}")
        check(vs_twin["ok"], f"{name}: kernel vs twin {vs_twin}")
        check(vs_wave["ok"], f"{name}: kernel vs torch wavefront {vs_wave}")
        perm = torch.randperm(verify.num_pixels, device=dev).to(torch.int32)
        check(torch.equal(k1.render_mxu(scene, cam, verify, perm=perm),
                          k1.render_mxu(scene, cam, verify)),
              f"{name}: a random perm changed the kernel image")
        verify_times[name] = (kern_ms, plain_ms)

    # ---- 4a. K1 vs twin on the reference frame's lanes -------------------
    ref_cfg = RenderConfig(width=1920, height=1080, samples_per_pixel=64,
                           max_depth=3)
    ref_scene = scenes.reference_scene(0, device=dev)[0]
    ref_cam = scenes.rtiow_final_camera(ref_cfg.aspect, device=dev)
    ref_pids = torch.arange(k1.lane_pad(ref_cfg.num_pixels), dtype=torch.int32,
                            device=dev)
    args = lane_args(ref_scene, ref_cam, ref_cfg, ref_pids)
    ref_ms, (fb, _) = cuda_ms(lambda: k1.render_lanes(*args), 5)
    plain_ms, (fb_plain, _) = cuda_ms(lambda: k1.render_lanes_plain(*args), 1,
                                      warm=False)
    ref_vs_twin = compare(image(fb, ref_cfg), image(fb_plain, ref_cfg),
                          COMPILED)
    log(f"[reference] kernel {ref_ms:.3f} ms, twin {plain_ms:.1f} ms, "
        f"{ref_scene.count} spheres; vs twin {ref_vs_twin}")
    check(ref_vs_twin["ok"], f"reference frame: kernel vs twin {ref_vs_twin}")
    del fb_plain

    # ---- 4. the main path: Renderer sessions + the flagship --------------
    k1.render_lanes.launches = 0
    r = Renderer(ref_cfg, backend="cuda", device=dev)
    frame_ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        img = r.render_frame(ref_scene, ref_cam)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    log("[reference] Renderer frames (probe, then cached perm): "
        + ", ".join(f"{m:.2f} ms" for m in frame_ms)
        + f"; {ref_cfg.rays_per_frame / (min(frame_ms[1:]) / 1e3) / 1e6:.1f}"
        f"M rays/s at the best cached-perm frame")
    check(tuple(img.shape) == (1080, 1920, 3), f"frame shape {img.shape}")
    check(bool(torch.isfinite(img).all()), "reference frame not finite")
    last_frame = r.frame - 1

    flag_cfg = RenderConfig(width=1200, height=800, samples_per_pixel=256,
                            max_depth=8)
    flag_scene = scenes.rtiow_final_scene(0, device=dev)[0]
    flag_cam = scenes.rtiow_final_camera(flag_cfg.aspect, device=dev)
    flag_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        flag = k1.render_mxu_balanced(flag_scene, flag_cam, flag_cfg)
        torch.cuda.synchronize()
        flag_s.append(time.perf_counter() - t0)
    launches = k1.render_lanes.launches
    check(tuple(flag.shape) == (800, 1200, 3) and bool(
        torch.isfinite(flag).all()), "flagship image not finite")
    flag_rps = flag_cfg.rays_per_frame / min(flag_s)
    log(f"[flagship] 1200x800x256 depth 8, {flag_scene.count} spheres: "
        + ", ".join(f"{s:.3f} s" for s in flag_s)
        + f" -> {flag_rps / 1e6:.1f}M rays/s on {smi}")

    # ---- 4b. one stripe of the last Renderer frame against the twin ------
    lo = 1000 * 1920  # 16,384 pixels from row 1000
    stripe = torch.arange(lo, lo + 16384, dtype=torch.int32, device=dev)
    fb_s, _ = k1.render_lanes_plain(*lane_args(ref_scene, ref_cam, ref_cfg,
                                               stripe, last_frame))
    got = img.reshape(-1, 3)[lo:lo + 16384].cpu().numpy()
    stripe_vs = compare(got, (fb_s / ref_cfg.samples_per_pixel).cpu().numpy(),
                        COMPILED)
    log(f"[reference] frame {last_frame} stripe vs twin {stripe_vs}")
    check(stripe_vs["ok"], f"reference stripe vs twin {stripe_vs}")

    # ---- 6. launches ------------------------------------------------------
    log(f"[launches] k1_render launches={launches} over the main path")
    check(launches > 0, "K1 was not launched by the main path")

    k1_entry = {
        "name": "k1_render", "route": "cuda",
        "source": "bevy_raytrace_tpu_torch/csrc/k1_render.cu",
        "replaces": "bevy_raytrace_tpu/kernels/mxu_render.py:99",
        "launches": launches,
        "max_abs_err": ref_vs_twin["max_abs_err"],
        "ms": ref_ms, "plain_ms": plain_ms,
    }
    grad_entries, grad_stats = gradient_phases(dev, smi)
    log(json.dumps({"kernels": [k1_entry, *grad_entries]}))
    log(json.dumps({"build_s": build_s, "verify_ms": verify_times,
                    "reference_frame_ms": frame_ms,
                    "flagship_s": flag_s, "flagship_rays_per_s": flag_rps,
                    **grad_stats}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
