#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (the forward render of a frame through the K1
CUDA kernel) from a checkout of this repository, and fails loudly — a
traceback and a nonzero exit — if any phase fails:

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
  6. K1's launch count over phases 4-5 must be > 0.

Kernel times are CUDA-event times.  Prints a {"kernels": [...]} line, the
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


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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

    log(json.dumps({"kernels": [{
        "name": "k1_render", "route": "cuda",
        "source": "bevy_raytrace_tpu_torch/csrc/k1_render.cu",
        "replaces": "bevy_raytrace_tpu/kernels/mxu_render.py:99",
        "launches": launches,
        "max_abs_err": ref_vs_twin["max_abs_err"],
        "ms": ref_ms, "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"build_s": build_s, "verify_ms": verify_times,
                    "reference_frame_ms": frame_ms,
                    "flagship_s": flag_s, "flagship_rays_per_s": flag_rps}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
