"""Where the time of the port's gradient path goes on one NVIDIA GPU, what
bounds K3, and the forward kernels side by side.

    python3 -m bevy_raytrace_tpu_torch.profile_grad [--out DIR] [--reps N]
        [--parts k3,forward,profile]

1. Profile: `torch.profiler` over one step of each gradient shape that
   `chip_smoke.py` drives, after one warm-up step: the `cli inverse` step
   (`optimize`, 1200x800x64, depth 8, config1 perturbed, edge_softness
   0.01: two K2 renders and two K3 backwards) and the flagship gradient
   (1200x800x256, depth 8, rtiow_final, d mean(img^2) / d centers),
   unchunked, with grad_spp_chunk=64, and recorded by K4 (forward="sweep");
   then the same gradient through `make_fast_renderer_sharded` in a
   torch.distributed group of world size 1 on nccl, recorded by K2 and by
   K4 (stripe-mode kernels, one all-gather, one all-reduce).  Per shape:
   wall ms (host clock to synchronize), the device time of each kernel, the
   device's idle share (1 - the kernels' sum / wall) and the peak device
   memory.
2. K3 probes: the kernel against builds of the same source with the d_table
   atomics in float32, with no d_table atomics, and with __launch_bounds__
   asking for 8 blocks per SM (csrc/k3_replay_grad.cu, "Measurement
   probes"), all on the same K2 residuals and cotangent, interleaved
   (A B C D, A B C D, ...) and timed with CUDA events, at the gradient
   bench (rtiow, 400x300x16, edge 0.01), the inverse step (config1,
   1200x800x64, edge 0.01) and a flagship slice (rtiow, 1200x800x64,
   edge 0).  Each shape also reports the hit bounces per path and the share
   of them on the most-hit sphere, which set the atomics' count and
   contention.
3. Forward kernels on the same paths: K1 (the forward render, identity
   lanes), K2 (the recorder on the expanded quadratic) and K4 (the recorder
   on K1's dense sweep), each recorder with and without the runner-up, and
   K2 with the cluster-culled traversal at cluster sizes 6, 12, 24 and 48,
   interleaved and timed with CUDA events at the gradient bench, a
   32-sample slice of the flagship (rtiow, 1200x800, depth 8) and the
   reference frame (reference_scene, 1920x1080, 64 spp, depth 3), with the
   executed rounds per path from K1's `len` output and a SHA-256 of each
   kernel's outputs (two builds of a kernel that print the same digest
   computed the same bits).

Prints a line per measurement, then the card's name and power limit, then
one JSON object with every number.  `--out DIR` also writes the profiler
tables there.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

# K3 builds compared by the probes: name -> nvcc -D defines.
VARIANTS = {
    "kernel": (),
    "f32_atomics": ("BRT_K3_TABLE_ADD=32",),
    "no_table_atomics": ("BRT_K3_TABLE_ADD=0",),
    "min_blocks_8": ("BRT_K3_MIN_BLOCKS=8",),
}


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cli_inverse_problem(device, backward: str = "kernel"):
    """The `cli inverse` problem at its defaults: 1200x800, 64 spp, depth 8,
    edge_softness 0.01, config1 with the ball's albedo and center perturbed
    (the reference's cli.py).  Returns (perturbed scene, true scene,
    InverseProblem on make_fast_renderer(backward=...))."""
    import torch

    from bevy_raytrace_tpu_torch import RenderConfig, scenes
    from bevy_raytrace_tpu_torch.inverse import (
        InverseProblem,
        make_fast_renderer,
    )
    from bevy_raytrace_tpu_torch.wavefront.render import render

    cfg = RenderConfig(width=1200, height=800, samples_per_pixel=64,
                       max_depth=8)
    scene_true = scenes.baseline_config1_scene(device=device)[0]
    camera = scenes.baseline_config1_camera(cfg.aspect, device=device)
    with torch.no_grad():
        target = render(scene_true, camera, cfg, 9999)
    albedo = scene_true.materials.albedo.clone()
    albedo[1] = torch.tensor([0.2, 0.8, 0.6], device=device)
    centers = scene_true.centers.clone()
    centers[1] += torch.tensor([0.25, -0.1, 0.1], device=device)
    scene_bad = dataclasses.replace(
        scene_true, centers=centers,
        materials=dataclasses.replace(scene_true.materials, albedo=albedo))
    opt_cfg = cfg.replace(edge_softness=0.01)
    fast = make_fast_renderer(opt_cfg, backward=backward)
    problem = InverseProblem(
        config=opt_cfg, camera=camera, target=target,
        optimizable=("centers", "albedo"),
        render_fn=lambda sc, c, cf, fr: fast(sc, c, fr))
    return scene_bad, scene_true, problem


def _profile(name, step, out_dir):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only: an operator's row also carries its kernels'
    # device time, and counting both would count that time twice.
    rows = [(e.self_device_time_total / 1e3, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": max(0.0, 1.0 - busy / wall_ms),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "top": [[k, ms, n] for ms, k, n in rows[:8]]}
    log(f"[profile] {name}: wall {wall_ms:.1f} ms, device busy {busy:.1f} "
        f"ms, idle share {out['idle_share']:.2%}, peak "
        f"{out['peak_gib']:.2f} GiB")
    for ms, k, n in rows[:8]:
        log(f"[profile]   {ms:10.2f} ms  x{n:<4d} {k[:100]}")
    if out_dir:
        with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
            f.write(prof.key_averages().table(row_limit=40))
    return out


def profile_steps(dev, out_dir):
    """Part 1 -> {shape: profile summary}."""
    import torch

    import socket

    import torch.distributed as dist

    from bevy_raytrace_tpu_torch import RenderConfig, scenes
    from bevy_raytrace_tpu_torch.inverse import (
        make_fast_renderer,
        make_fast_renderer_sharded,
        optimize,
    )
    from bevy_raytrace_tpu_torch.shard import initialize_multihost, make_mesh

    scene_bad, _, problem = cli_inverse_problem(dev)
    res = {"inverse_step": _profile(
        "inverse_step",
        lambda: optimize(scene_bad, problem, steps=1, learning_rate=1.5e-2),
        out_dir)}
    big = RenderConfig(width=1200, height=800, samples_per_pixel=256,
                       max_depth=8)
    rt = scenes.rtiow_final_scene(0, device=dev)[0]
    cam = scenes.rtiow_final_camera(big.aspect, device=dev)

    def profile_gradient(name, render_fn):
        def step():
            c = rt.centers.clone().requires_grad_(True)
            loss = torch.mean(
                render_fn(dataclasses.replace(rt, centers=c), cam, 1) ** 2)
            return torch.autograd.grad(loss, c)[0]

        res[name] = _profile(name, step, out_dir)

    for chunk in (0, 64):
        profile_gradient(f"flagship_grad_chunk{chunk}",
                         make_fast_renderer(big, grad_spp_chunk=chunk))
    profile_gradient("flagship_grad_sweep",
                     make_fast_renderer(big, forward="sweep"))

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    initialize_multihost(f"127.0.0.1:{port}", 1, 0)
    mesh = make_mesh()
    for forward in ("pallas", "sweep"):
        sharded = make_fast_renderer_sharded(big, mesh, forward=forward)
        profile_gradient(
            f"sharded_flagship_grad_{forward}",
            lambda sc, c, frame, sharded=sharded: sharded(sc, c, frame,
                                                          gather=True))
    dist.destroy_process_group()
    return res


def k3_probes(dev, reps):
    """Part 2 -> {shape: {paths, hits_per_path, top_row_share, ms: {variant:
    [ms, ...]}}, and the variants' ptxas lines."""
    import numpy as np
    import torch

    from bevy_raytrace_tpu_torch import RenderConfig, scenes
    from bevy_raytrace_tpu_torch.kernels import build
    from bevy_raytrace_tpu_torch.kernels import record as k2
    from bevy_raytrace_tpu_torch.kernels import replay_grad as k3

    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        list(pool.map(lambda d: build.load("k3_replay_grad", d),
                      VARIANTS.values()))
    ptxas = {}
    for v, defines in VARIANTS.items():
        _, text = build.BUILD_LOG.get(build._key("k3_replay_grad", defines),
                                      (0.0, ""))
        ptxas[v] = [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "stack frame" in ln]
        for ln in ptxas[v]:
            log(f"[build] k3 {v}: {ln}")
    launchers = {v: k3._k3_launcher(d) for v, d in VARIANTS.items()}

    rtiow = (scenes.rtiow_final_scene, scenes.rtiow_final_camera)
    config1 = (scenes.baseline_config1_scene, scenes.baseline_config1_camera)
    shapes = {
        "grad_bench": (rtiow, RenderConfig(width=400, height=300,
                                           samples_per_pixel=16, max_depth=8,
                                           edge_softness=0.01)),
        "inverse": (config1, RenderConfig(width=1200, height=800,
                                          samples_per_pixel=64, max_depth=8,
                                          edge_softness=0.01)),
        "flagship_slice": (rtiow, RenderConfig(width=1200, height=800,
                                               samples_per_pixel=64,
                                               max_depth=8)),
    }
    out = {}
    for name, ((scene_fn, cam_fn), cfg) in shapes.items():
        scene = scene_fn(device=dev)[0]
        cam = cam_fn(cfg.aspect, device=dev)
        table, cam16 = k2._operands(scene, cam)
        edge = cfg.edge_softness > 0.0
        _, res, res2 = k2.record_frame(table, cam16, cfg, 1,
                                       record_second=edge)
        g = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (cfg.height, cfg.width, 3)).astype(np.float32)).to(dev)
        hits = res[res >= 0].long()
        paths = cfg.rays_per_frame
        per_row = torch.bincount(hits, minlength=table.shape[0])
        stats = {"paths": paths, "hits_per_path": hits.numel() / paths,
                 "top_row_share": float(per_row.max()) / max(hits.numel(), 1),
                 "ms": {v: [] for v in VARIANTS}}
        del hits, per_row

        def run(v):
            return k3._launch(launchers[v], table, cam16, cfg, res, g, 1, 0,
                              res2)

        for v in VARIANTS:  # warm-up
            run(v)
        for _ in range(reps):
            for v in VARIANTS:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run(v)
                end.record()
                torch.cuda.synchronize()
                stats["ms"][v].append(start.elapsed_time(end))
        log(f"[k3 probe] {name}: {paths} paths, "
            f"{stats['hits_per_path']:.3f} hit bounces per path, "
            f"{stats['top_row_share']:.1%} of hits on the most-hit sphere")
        base = float(np.median(stats["ms"]["kernel"]))
        for v, ms in stats["ms"].items():
            med = float(np.median(ms))
            log(f"[k3 probe]   {v:18s} median {med:10.3f} ms "
                f"({med / base:6.3f} x kernel), {med * 1e6 / paths:.3f} "
                f"ns/path; runs {[round(m, 3) for m in ms]}")
        out[name] = stats
        del res, res2
    return out, ptxas


def forward_kernels(dev, reps):
    """Part 3 -> {shape: {spheres, paths, rounds_per_path, ms: {kernel:
    [ms, ...]}}}."""
    import numpy as np
    import torch

    from bevy_raytrace_tpu_torch import RenderConfig, scenes
    from bevy_raytrace_tpu_torch.kernels import record as k2
    from bevy_raytrace_tpu_torch.kernels import render_lanes as k1
    from bevy_raytrace_tpu_torch.kernels import sweep_record as k4
    from bevy_raytrace_tpu_torch.kernels.clusters import cluster_scene
    from bevy_raytrace_tpu_torch.wavefront.render import frame_seed

    rtiow = (scenes.rtiow_final_scene, scenes.rtiow_final_camera)
    shapes = {
        "grad_bench": (rtiow, RenderConfig(width=400, height=300,
                                           samples_per_pixel=16, max_depth=8,
                                           edge_softness=0.01)),
        "flagship_slice_32spp": (rtiow, RenderConfig(
            width=1200, height=800, samples_per_pixel=32, max_depth=8)),
        "reference_frame": ((scenes.reference_scene,
                             scenes.rtiow_final_camera),
                            RenderConfig(width=1920, height=1080,
                                         samples_per_pixel=64, max_depth=3)),
    }
    out = {}
    for name, ((scene_fn, cam_fn), cfg) in shapes.items():
        scene = scene_fn(device=dev)[0]
        cam = cam_fn(cfg.aspect, device=dev)
        table, cam16 = k2._operands(scene, cam)
        geom, attr = k1._scene_tables(scene)
        pids = torch.arange(k1.lane_pad(cfg.num_pixels), dtype=torch.int32,
                            device=dev)

        def run_k1():
            return k1.render_lanes(geom, attr, cam16, pids,
                                   frame_seed(cfg, 1), 0,
                                   cfg.samples_per_pixel, cfg.max_depth,
                                   cfg.t_min, cfg.width, cfg.height)

        runs = {"k1": run_k1}
        for label, fn in (("k2", k2.record_frame),
                          ("k4", k4.sweep_record_frame)):
            for second in (False, True):
                runs[label + "_record" + "_second" * second] = (
                    lambda fn=fn, second=second: fn(table, cam16, cfg, 1,
                                                    record_second=second))
        for size in (6, 12, 24, 48):
            runs[f"k2_culled_L{size}_record"] = (
                lambda plan=cluster_scene(scene, size): k2.record_frame(
                    table, cam16, cfg, 1, clusters=plan))
        stats = {"spheres": scene.count, "paths": cfg.rays_per_frame,
                 "rounds_per_path": float(run_k1()[1][:cfg.num_pixels].sum())
                 / cfg.rays_per_frame,
                 "ms": {k: [] for k in runs}, "sha256": {}}
        for k, fn in runs.items():  # warm-up, and the outputs' digest
            h = hashlib.sha256()
            for t in fn():
                if t is not None:
                    h.update(t.cpu().numpy().tobytes())
            stats["sha256"][k] = h.hexdigest()[:16]
        torch.cuda.synchronize()
        for _ in range(reps):
            for k, fn in runs.items():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                stats["ms"][k].append(start.elapsed_time(end))
        log(f"[forward] {name}: {scene.count} spheres, {cfg.rays_per_frame} "
            f"paths, {stats['rounds_per_path']:.3f} executed rounds per path")
        base = float(np.median(stats["ms"]["k1"]))
        for k, ms in stats["ms"].items():
            med = float(np.median(ms))
            log(f"[forward]   {k:22s} median {med:9.3f} ms ({med / base:6.3f} "
                f"x k1); outputs sha256 {stats['sha256'][k]}; runs "
                f"{[round(m, 3) for m in ms]}")
        out[name] = stats
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for the profiler tables")
    ap.add_argument("--reps", type=int, default=5,
                    help="interleaved rounds of the K3 probes and of the "
                         "forward kernels")
    ap.add_argument("--parts", default="k3,forward,profile",
                    help="comma list of the parts to run: k3 (its probes), "
                         "forward (K1, K2, K4 interleaved), profile")
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    if not torch.cuda.is_available():
        print("profile_grad: no CUDA device", file=sys.stderr)
        return 2
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda")
    smi = smi_line()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    probes, ptxas = k3_probes(dev, args.reps) if "k3" in parts else ({}, {})
    forward = forward_kernels(dev, args.reps) if "forward" in parts else {}
    prof = profile_steps(dev, args.out) if "profile" in parts else {}
    log(smi)
    log(json.dumps({"device": smi, "k3_probes": probes, "k3_ptxas": ptxas,
                    "forward_kernels": forward, "profile": prof}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
