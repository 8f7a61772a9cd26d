"""Where the time of the port's gradient path goes on one NVIDIA GPU, what
bounds K3, and the forward kernels side by side.

    python3 -m bevy_raytrace_tpu_torch.profile_grad [--out DIR] [--reps N]
        [--parts k3,forward,efficiency,profile] [--k3-variants kernel,...]

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
2. K3 probes: the kernel (`replay_grad`) against its global table mode
   forced, and against builds of the same source for the A/B of its design
   steps (csrc/k3_replay_grad.cu, "Measurement probes"): without the warp
   aggregation (step_a), with neither persistence nor aggregation nor a
   block table (lane_atomics: every lane's float64 atomics into d_table,
   one block per 128 paths) and with no table adds at all
   (no_table_atomics, the floor), all on the
   same K2 residuals and cotangent, interleaved (A B C D, A B C D, ...) and
   timed with CUDA events, at the gradient bench (rtiow, 400x300x16, edge
   0.01), the inverse step (config1, 1200x800x64, edge 0.01) and a
   flagship slice (rtiow, 1200x800x64, edge 0).  Each shape also reports
   the hit bounces per path and the share of them on the most-hit sphere.
   `--k3-variants kernel` times `replay_grad` alone, which any commit of
   the port has: run this file from another tree for a same-call A/B.
3. Forward kernels on the same paths: K1 (the forward render, identity
   lanes), K2 (the recorder on the expanded quadratic: brute force and
   culled at cluster size 12; value only, winners, winners + runner-up)
   and K4 (the recorder on K1's dense sweep, with and without the
   runner-up), interleaved and timed with CUDA events at the gradient
   bench (also K2 culled at cluster sizes 6, 24 and 48), the flagship
   gradient's 2-sample slice (rtiow, 1200x800, samples 128-129, depth 8),
   the `cli render` frame (rtiow, 1200x800, 64 spp, depth 8) and the
   reference frame (reference_scene, 1920x1080, 64 spp, depth 3; value
   only) and the flagship frame (rtiow, 1200x800, 256 spp, depth 8; K1 and
   K4 recording winners), with the executed rounds per path from K1's `len`
   output and a SHA-256 of each kernel's outputs (two builds of a kernel
   that print the same digest computed the same bits).  K1 and K4 also run
   with the sphere rows read from device memory (the global table mode,
   forced; its digests must equal the staged table's), and both modes are
   timed on seeded scenes of 2,000 to 14,000 spheres: at the largest table
   each count of resident blocks (7 down to 3) admits, and above.
4. Lane efficiency (`--parts efficiency`, no timing): K1 launched once per
   sample (spp=1, sample_base=s), so `len` holds each (sample, lane)'s
   executed rounds; per warp of 32 lanes, the share of lane-rounds that do
   work under the nested schedule (every lane waits for the warp's longest
   path of each sample) and under the per-lane refill (a lane waits only for
   the warp's longest total), at the forward shapes of part 3 and at the
   flagship frame in K1's balanced order (a 16-sample probe, then the rest
   on `balance_perm`) and in K4's identity order.

Prints a line per measurement, then the card's name and power limit, then
one JSON object with every number.  `--out DIR` also writes the profiler
tables there.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

# K3 variants compared by the probes: name -> (nvcc -D defines, table mode;
# None = the mode `replay_grad` picks).  "kernel" is timed through
# `replay_grad` itself, so that `--k3-variants kernel` also times a tree
# whose K3 has no probes (an A/B against another commit).
VARIANTS = {
    "kernel": ((), None),
    "global_table": ((), "global"),
    "step_a": (("BRT_K3_STEP=1",), None),
    "lane_atomics": (("BRT_K3_STEP=0",), None),
    "no_table_atomics": (("BRT_K3_TABLE_ADD=0",), None),
}


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _perturbed_problem(cfg, target_frame, shift, device, backward, forward):
    """config1 rendered by the wavefront at `target_frame`; the ball's albedo
    set to (0.2, 0.8, 0.6) and its center moved by `shift`; the center and
    albedo optimizable at edge_softness 0.01.  -> (perturbed scene, true
    scene, InverseProblem)."""
    import torch

    from bevy_raytrace_tpu_torch import scenes
    from bevy_raytrace_tpu_torch.inverse import (
        InverseProblem,
        make_fast_renderer,
    )
    from bevy_raytrace_tpu_torch.wavefront.render import render

    scene_true = scenes.baseline_config1_scene(device=device)[0]
    camera = scenes.baseline_config1_camera(cfg.aspect, device=device)
    with torch.no_grad():
        target = render(scene_true, camera, cfg, target_frame)
    albedo = scene_true.materials.albedo.clone()
    albedo[1] = torch.tensor([0.2, 0.8, 0.6], device=device)
    centers = scene_true.centers.clone()
    centers[1] += torch.tensor(shift, device=device)
    scene_bad = dataclasses.replace(
        scene_true, centers=centers,
        materials=dataclasses.replace(scene_true.materials, albedo=albedo))
    opt_cfg = cfg.replace(edge_softness=0.01)
    render_fn = None
    if forward != "wavefront":
        fast = make_fast_renderer(opt_cfg, backward=backward, forward=forward)
        render_fn = lambda sc, c, cf, fr: fast(sc, c, fr)  # noqa: E731
    problem = InverseProblem(
        config=opt_cfg, camera=camera, target=target,
        optimizable=("centers", "albedo"), render_fn=render_fn)
    return scene_bad, scene_true, problem


def cli_inverse_problem(device, backward: str = "kernel",
                        forward: str = "pallas"):
    """The `cli inverse` problem at its defaults: 1200x800, 64 spp, depth 8,
    edge_softness 0.01, config1 with the ball's albedo and center perturbed
    (the reference's cli.py).  Returns (perturbed scene, true scene,
    InverseProblem).  `forward` "pallas" (K2) or "sweep" (K4) differentiates
    make_fast_renderer(backward=..., forward=...); "wavefront" leaves
    render_fn None, so the loss differentiates the wavefront `render`."""
    from bevy_raytrace_tpu_torch import RenderConfig

    cfg = RenderConfig(width=1200, height=800, samples_per_pixel=64,
                       max_depth=8)
    return _perturbed_problem(cfg, 9999, [0.25, -0.1, 0.1], device,
                              backward, forward)


def ball_inverse_problem(device, forward: str = "pallas"):
    """The reference's recovery test (tests/test_inverse.py
    `test_optimization_reduces_loss_and_recovers`): 32x24, 4 spp, depth 3,
    the target rendered at frame 12345, the ball's center moved by (0.06,
    -0.04, 0.05), edge_softness 0.01.  Returns what `cli_inverse_problem`
    returns, `forward` as there.  The wavefront traces the 4 samples in one
    pass (spp_chunk 4: the same samples, a quarter of the launches of one
    pass a sample; the fast renderer does not read it)."""
    from bevy_raytrace_tpu_torch import RenderConfig

    cfg = RenderConfig(width=32, height=24, samples_per_pixel=4, max_depth=3,
                       spp_chunk=4)
    return _perturbed_problem(cfg, 12345, [0.06, -0.04, 0.05], device,
                              "kernel", forward)


def ball_errors(scene, scene_true):
    """(center error, albedo error) of the ball (sphere 1): the L2 distance
    of its center and the largest channel error of its albedo, as the
    reference's recovery test measures them."""
    c = float((scene.centers[1] - scene_true.centers[1]).norm())
    a = float((scene.materials.albedo[1]
               - scene_true.materials.albedo[1]).abs().max())
    return c, a


# The reference recovery test's bars (tests/test_inverse.py): the last loss
# below LOSS x the first, the center error below CENTER x the initial, the
# albedo error below ALBEDO.
RECOVERY_BARS = {"loss": 0.3, "center": 0.4, "albedo": 0.08}


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


def k3_probes(dev, reps, variants):
    """Part 2 -> {shape: {paths, hits_per_path, top_row_share, ms: {variant:
    [ms, ...]}}}, and the variants' ptxas lines."""
    import numpy as np
    import torch

    from bevy_raytrace_tpu_torch import RenderConfig, scenes
    from bevy_raytrace_tpu_torch.kernels import build
    from bevy_raytrace_tpu_torch.kernels import record as k2
    from bevy_raytrace_tpu_torch.kernels import replay_grad as k3

    builds = sorted({VARIANTS[v][0] for v in variants})
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda d: build.load("k3_replay_grad", d), builds))
    ptxas = {}
    for v in variants:
        _, text = build.BUILD_LOG.get(
            build._key("k3_replay_grad", VARIANTS[v][0]), (0.0, ""))
        ptxas[v] = [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "stack frame" in ln]
        for ln in ptxas[v]:
            log(f"[build] k3 {v}: {ln}")

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
                 "ms": {v: [] for v in variants}}
        del hits, per_row

        def run(v):
            if v == "kernel":
                return k3.replay_grad(table, cam16, cfg, res, g, 1, res2=res2)
            defines, mode = VARIANTS[v]
            return k3._launch(k3._k3_launcher(defines), table, cam16, cfg,
                              res, g, 1, 0, res2,
                              table_mode=mode or k3._table_mode(table))

        for v in variants:  # warm-up
            run(v)
        for _ in range(reps):
            for v in variants:
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


WARP = 32


def lane_rounds(geom, attr, cam16, pids, seed, sample_base, spp, max_depth,
                t_min, width, height):
    """Executed rounds of each (sample, lane) -> float32 [spp, lanes]: K1
    (`render_lanes`, or its twin on CPU tensors) launched once per sample
    with spp=1, so its `len` output counts that sample's rounds alone."""
    import torch

    from bevy_raytrace_tpu_torch.kernels import render_lanes as k1

    return torch.stack([
        k1.render_lanes(geom, attr, cam16, pids, seed, sample_base + s, 1,
                        max_depth, t_min, width, height)[1]
        for s in range(spp)])


def schedule_efficiency(rounds):
    """Lane efficiency of the two schedules from `rounds` [spp, lanes]
    (lanes a multiple of 32; consecutive lanes share a warp) -> {work,
    nested_slots, refill_slots, nested, refill}.

    work is the sum of the rounds.  Under the nested schedule (for each
    sample, for each bounce) a warp runs, per sample, its longest lane's
    rounds: nested_slots = 32 * sum over warps and samples of that maximum.
    Under the per-lane refill a warp runs its longest lane's total over all
    samples: refill_slots = 32 * sum over warps of that maximum.  Each
    efficiency is work / slots (1.0 where there is no work)."""
    import torch

    spp, lanes = rounds.shape
    if lanes % WARP:
        raise ValueError(f"lanes must be a multiple of {WARP}, got {lanes}")
    r = rounds.to(torch.float64).reshape(spp, lanes // WARP, WARP)
    work = float(r.sum())
    nested = WARP * float(r.amax(dim=2).sum()) if spp else 0.0
    refill = WARP * float(r.sum(dim=0).amax(dim=1).sum())
    return {"work": work, "nested_slots": nested, "refill_slots": refill,
            "nested": work / nested if nested else 1.0,
            "refill": work / refill if refill else 1.0}


def _joined(*effs):
    """The efficiencies of launches run one after another."""
    out = {k: sum(e[k] for e in effs)
           for k in ("work", "nested_slots", "refill_slots")}
    out["nested"] = out["work"] / out["nested_slots"]
    out["refill"] = out["work"] / out["refill_slots"]
    return out


def efficiencies(dev):
    """Part 4 -> {shape: schedule_efficiency(...) and rounds_per_path}."""
    import torch

    from bevy_raytrace_tpu_torch.kernels import record as k2
    from bevy_raytrace_tpu_torch.kernels import render_lanes as k1
    from bevy_raytrace_tpu_torch.wavefront.render import frame_seed

    out = {}
    for name, ((scene_fn, cam_fn), cfg, sb) in _forward_shapes().items():
        scene = scene_fn(device=dev)[0]
        cam = cam_fn(cfg.aspect, device=dev)
        _, cam16 = k2._operands(scene, cam)
        geom, attr = k1._scene_tables(scene)
        pids = torch.arange(k1.lane_pad(cfg.num_pixels), dtype=torch.int32,
                            device=dev)
        rounds = lane_rounds(geom, attr, cam16, pids, frame_seed(cfg, 1), sb,
                             cfg.samples_per_pixel, cfg.max_depth, cfg.t_min,
                             cfg.width, cfg.height)
        shapes = {name: schedule_efficiency(rounds)}
        if name == "flagship_frame":
            # K1's order (render_probed): samples 0-15 in raster order, then
            # the rest on balance_perm of the probe's mean path length.
            n = cfg.num_pixels
            probe = rounds[:16, :n]
            perm = k1.balance_perm((probe.sum(0) / 16).reshape(
                cfg.height, cfg.width)).long()
            rest = rounds[16:, :n][:, perm]
            shapes = {"flagship_frame_identity (K4's order)": shapes[name],
                      "flagship_frame_balanced (K1's order)": _joined(
                          schedule_efficiency(probe),
                          schedule_efficiency(rest))}
            del probe, rest
        for label, eff in shapes.items():
            eff["rounds_per_path"] = eff["work"] / cfg.rays_per_frame
            log(f"[efficiency] {label}: {eff['rounds_per_path']:.4f} rounds "
                f"per path; lane efficiency nested {eff['nested']:.4f}, "
                f"refill {eff['refill']:.4f} (refill / nested "
                f"{eff['refill'] / eff['nested']:.3f}x)")
            out[label] = eff
        del rounds
    return out


def _forward_shapes():
    """name -> ((scene fn, camera fn), config, sample_base) of part 3."""
    from bevy_raytrace_tpu_torch import RenderConfig, scenes

    rtiow = (scenes.rtiow_final_scene, scenes.rtiow_final_camera)
    flagship = RenderConfig(width=1200, height=800, samples_per_pixel=64,
                            max_depth=8)
    return {
        "grad_bench": (rtiow, RenderConfig(width=400, height=300,
                                           samples_per_pixel=16, max_depth=8,
                                           edge_softness=0.01), 0),
        "flagship_slice_2spp": (rtiow, flagship.replace(samples_per_pixel=2),
                                128),
        "cli_frame": (rtiow, flagship, 0),
        "reference_frame": ((scenes.reference_scene,
                             scenes.rtiow_final_camera),
                            RenderConfig(width=1920, height=1080,
                                         samples_per_pixel=64, max_depth=3),
                            0),
        "flagship_frame": (rtiow, flagship.replace(samples_per_pixel=256), 0),
    }


def random_scene(n, seed=0, device=None):
    """A seeded scene of `n` spheres: the RTiOW ground and n - 1 small
    spheres of mixed materials scattered over it, denser than
    rtiow_final's (tables up to and above a block's shared memory)."""
    import numpy as np

    from bevy_raytrace_tpu_torch.core.types import make_scene

    rng = np.random.default_rng(seed)
    m = n - 1
    r = rng.uniform(0.05, 0.25, m)
    xz = rng.uniform(-11.0, 11.0, (m, 2))
    centers = np.concatenate([[[0.0, -1000.0, 0.0]],
                              np.stack([xz[:, 0], r, xz[:, 1]], 1)])
    return make_scene(
        centers, np.concatenate([[1000.0], r]), np.arange(n),
        np.concatenate([[[0.5, 0.5, 0.5]], rng.uniform(0.1, 0.9, (m, 3))]),
        np.concatenate([[0], rng.choice(3, m, p=[0.7, 0.2, 0.1])]),
        np.concatenate([[0.0], rng.uniform(0.0, 0.5, m)]),
        np.full(n, 1.5), device=device)


# Seeded scenes at which both table modes are timed (part 3): 2,000, 2,368,
# 2,848 and 3,584 rows are the largest tables at which 7, 6, 5 and 4 blocks
# stay resident on an H100 (the occupancy API, 56 registers a thread); 2,400,
# 3,000 and 3,500 fall between; 4,096 leaves 3 blocks.
TABLE_SIZES = (2000, 2368, 2400, 2848, 3000, 3500, 3584, 4096, 8192, 14000)


def _digest(outputs):
    """SHA-256 (16 hex digits) of a kernel's output tensors, moved to the
    host 256 MiB at a time."""
    h = hashlib.sha256()
    for t in outputs:
        if t is None:
            continue
        flat = t.reshape(-1)
        step = (256 << 20) // max(flat.element_size(), 1)
        for lo in range(0, flat.numel(), step):
            h.update(flat[lo:lo + step].cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _time_runs(name, runs, reps, stats):
    """Warm-up (and the digests), then `reps` interleaved rounds of CUDA
    events over `runs`; logs the medians against the first run's."""
    import numpy as np
    import torch

    stats["ms"] = {k: [] for k in runs}
    stats["sha256"] = {}
    for k, fn in runs.items():
        stats["sha256"][k] = _digest(fn())
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
    first = next(iter(runs))
    base = float(np.median(stats["ms"][first]))
    for k, ms in stats["ms"].items():
        med = float(np.median(ms))
        log(f"[forward]   {k:26s} median {med:9.3f} ms ({med / base:6.3f} "
            f"x {first}); outputs sha256 {stats['sha256'][k]}; runs "
            f"{[round(m, 3) for m in ms]}")


def forward_kernels(dev, reps):
    """Part 3 -> {shape: {spheres, paths, rounds_per_path, ms: {kernel:
    [ms, ...]}, sha256: {kernel: digest}}}."""
    import torch

    from bevy_raytrace_tpu_torch import RenderConfig, scenes
    from bevy_raytrace_tpu_torch.kernels import build, common
    from bevy_raytrace_tpu_torch.kernels import record as k2
    from bevy_raytrace_tpu_torch.kernels import render_lanes as k1
    from bevy_raytrace_tpu_torch.kernels import sweep_record as k4
    from bevy_raytrace_tpu_torch.kernels.clusters import cluster_scene
    from bevy_raytrace_tpu_torch.wavefront.render import frame_seed

    out = {}
    names = ("k1_render", "k4_sweep_record")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build.load, names)))
    limits = {}
    for name, lib in libs.items():
        _, text = build.BUILD_LOG.get(build._key(name, ()), (0.0, ""))
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"[build] {name}: {ln.strip()}")
        fn = getattr(lib, f"brt_{name.split('_')[0]}_table_bytes_limit")
        limits[name] = {}
        for blocks in range(1, 9):
            got = ctypes.c_int(0)
            check_rc = fn(blocks, ctypes.byref(got))
            if check_rc != 0:
                raise RuntimeError(f"{name} limit query: {check_rc}")
            limits[name][blocks] = got.value
        log(f"[forward] {name}: staged-table limit by resident blocks per SM "
            f"(occupancy API): {limits[name]}; the plan takes "
            f"{common.FORWARD_MIN_BLOCKS[name]}")
    out["table_limits"] = limits

    def k4_run(table, cam16, cfg, sb, second, mode=None):
        kw = {} if mode is None else {"table_mode": mode}
        return lambda: k4.sweep_record_frame(
            table, cam16, cfg, 1, sample_base=sb, record_second=second, **kw)

    records = {0: "_value", 1: "_record", 2: "_record_second"}
    for name, ((scene_fn, cam_fn), cfg, sb) in _forward_shapes().items():
        scene = scene_fn(device=dev)[0]
        cam = cam_fn(cfg.aspect, device=dev)
        table, cam16 = k2._operands(scene, cam)
        geom, attr = k1._scene_tables(scene)
        pids = torch.arange(k1.lane_pad(cfg.num_pixels), dtype=torch.int32,
                            device=dev)

        def run_k1(mode=None):
            kw = {} if mode is None else {"table_mode": mode}
            return lambda: k1.render_lanes(
                geom, attr, cam16, pids, frame_seed(cfg, 1), sb,
                cfg.samples_per_pixel, cfg.max_depth, cfg.t_min, cfg.width,
                cfg.height, **kw)

        runs = {"k1": run_k1(), "k1_global": run_k1("global")}
        if name == "flagship_frame":  # K1, and K4 as the gradient records
            record_modes = (1,)
        else:
            record_modes = (0, 1, 2) if name != "reference_frame" else (0,)
            plan = cluster_scene(scene, 12)
        for r in record_modes:
            kw = dict(sample_base=sb, with_residuals=r >= 1,
                      record_second=r == 2)
            if name != "flagship_frame":
                runs["k2" + records[r]] = (
                    lambda kw=kw: k2.record_frame(table, cam16, cfg, 1, **kw))
                runs["k2_culled_L12" + records[r]] = (
                    lambda kw=kw: k2.record_frame(table, cam16, cfg, 1,
                                                  clusters=plan, **kw))
            if r >= 1:
                runs["k4" + records[r]] = k4_run(table, cam16, cfg, sb, r == 2)
                runs["k4" + records[r] + "_global"] = k4_run(
                    table, cam16, cfg, sb, r == 2, "global")
        if name == "grad_bench":
            for size in (6, 24, 48):
                runs[f"k2_culled_L{size}_record"] = (
                    lambda plan=cluster_scene(scene, size): k2.record_frame(
                        table, cam16, cfg, 1, clusters=plan))
        stats = {"spheres": scene.count, "paths": cfg.rays_per_frame,
                 "rounds_per_path": float(runs["k1"]()[1][:cfg.num_pixels]
                                          .sum()) / cfg.rays_per_frame}
        log(f"[forward] {name}: {scene.count} spheres, {cfg.rays_per_frame} "
            f"paths, {stats['rounds_per_path']:.3f} executed rounds per path")
        _time_runs(name, runs, reps, stats)
        out[name] = stats
        del runs

    # Both table modes on seeded scenes from a 32 KB to a 224 KB table.
    cfg = RenderConfig(width=640, height=480, samples_per_pixel=4,
                       max_depth=8)
    cam = scenes.rtiow_final_camera(cfg.aspect, device=dev)
    for n in TABLE_SIZES:
        scene = random_scene(n, device=dev)
        table, cam16 = k2._operands(scene, cam)
        geom, attr = k1._scene_tables(scene)
        pids = torch.arange(k1.lane_pad(cfg.num_pixels), dtype=torch.int32,
                            device=dev)

        def run_k1(mode=None):
            kw = {} if mode is None else {"table_mode": mode}
            return lambda: k1.render_lanes(
                geom, attr, cam16, pids, frame_seed(cfg, 1), 0,
                cfg.samples_per_pixel, cfg.max_depth, cfg.t_min, cfg.width,
                cfg.height, **kw)

        runs = {"k1": run_k1(), "k1_shared": run_k1("shared"),
                "k1_global": run_k1("global"),
                "k4_record": k4_run(table, cam16, cfg, 0, False),
                "k4_record_shared": k4_run(table, cam16, cfg, 0, False,
                                           "shared"),
                "k4_record_global": k4_run(table, cam16, cfg, 0, False,
                                           "global")}
        label = f"random_{n}"
        stats = {"spheres": n, "paths": cfg.rays_per_frame,
                 "rounds_per_path": float(runs["k1"]()[1][:cfg.num_pixels]
                                          .sum()) / cfg.rays_per_frame}
        log(f"[forward] {label}: {n} spheres ({16 * n} B of rows), "
            f"{cfg.width}x{cfg.height}x{cfg.samples_per_pixel} depth "
            f"{cfg.max_depth}, {stats['rounds_per_path']:.3f} executed rounds "
            f"per path")
        _time_runs(label, runs, reps, stats)
        out[label] = stats
        del runs
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for the profiler tables")
    ap.add_argument("--reps", type=int, default=5,
                    help="interleaved rounds of the K3 probes and of the "
                         "forward kernels")
    ap.add_argument("--parts", default="k3,forward,efficiency,profile",
                    help="comma list of the parts to run: k3 (its probes), "
                         "forward (K1, K2, K4 interleaved), efficiency (K1's "
                         "lanes under the two schedules), profile")
    ap.add_argument("--k3-variants", default=",".join(VARIANTS),
                    help="comma list of the K3 variants to time, of "
                         + ", ".join(VARIANTS))
    args = ap.parse_args(argv)
    variants = args.k3_variants.split(",")
    unknown = set(variants) - set(VARIANTS)
    if unknown or "kernel" not in variants:
        ap.error(f"--k3-variants must name 'kernel' and only {list(VARIANTS)}")
    parts = args.parts.split(",")
    if not torch.cuda.is_available():
        print("profile_grad: no CUDA device", file=sys.stderr)
        return 2
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda")
    smi = smi_line()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    probes, ptxas = (k3_probes(dev, args.reps, variants) if "k3" in parts
                     else ({}, {}))
    forward = forward_kernels(dev, args.reps) if "forward" in parts else {}
    eff = efficiencies(dev) if "efficiency" in parts else {}
    prof = profile_steps(dev, args.out) if "profile" in parts else {}
    log(smi)
    log(json.dumps({"device": smi, "k3_probes": probes, "k3_ptxas": ptxas,
                    "forward_kernels": forward, "lane_efficiency": eff,
                    "profile": prof}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
