"""The forward kernels side by side on one NVIDIA GPU, and the share of
K1's lanes that do work under its schedule.

    python -m bevy_raytrace_tpu_torch.tools.forward_kernels [--reps N]
        [--parts forward,efficiency]

1. forward: K1 (the forward render, identity lanes), K2 (the recorder on
   the expanded quadratic: brute force and culled at cluster size 12; value
   only, winners, winners + runner-up) and K4 (the recorder on K1's dense
   sweep, with and without the runner-up) on the same paths, interleaved
   and timed with CUDA events at the gradient bench (rtiow, 400x300x16,
   edge 0.01; also K2 culled at cluster sizes 6, 24 and 48), the flagship
   gradient's 2-sample slice (rtiow, 1200x800, samples 128-129, depth 8),
   the `cli render` frame (rtiow, 1200x800, 64 spp, depth 8), the reference
   frame (reference_scene, 1920x1080, 64 spp, depth 3; value only) and the
   flagship frame (rtiow, 1200x800, 256 spp, depth 8; K1 and K4 recording
   winners), with the executed rounds per path from K1's `len` output and
   a SHA-256 of each kernel's outputs: two builds of a kernel that print
   the same digest computed the same bits, so running this file from two
   trees in one call holds a kernel to another tree's bits.  K1 and K4 also
   run with the sphere rows read from device memory (the global table
   mode, forced; its digests must equal the staged table's), and both
   modes are timed on seeded scenes of 2,000 to 14,000 spheres: at the
   largest table each count of resident blocks (7 down to 3) admits, and
   above.  The staged-table limits by resident blocks per SM come first.
2. efficiency (no timing): K1 launched once per sample (spp=1,
   sample_base=s), so `len` holds each (sample, lane)'s executed rounds;
   per warp of 32 lanes, the share of lane-rounds that do work under the
   nested schedule (every lane waits for the warp's longest path of each
   sample) and under the per-lane refill (a lane waits only for the warp's
   longest total), at the shapes of part 1 and at the flagship frame in
   K1's balanced order (a 16-sample probe, then the rest on `balance_perm`)
   and in K4's identity order.

Prints a line per measurement, then the card's name and power limit, then
one JSON object with every number.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import hashlib
import json
import sys


def log(*a):
    print(*a, flush=True)


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
    """Part 2 -> {shape: schedule_efficiency(...) and rounds_per_path}."""
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
    """name -> ((scene fn, camera fn), config, sample_base) of part 1."""
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


# Seeded scenes at which both table modes are timed (part 1): 2,000, 2,368,
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
    """Part 1 -> {shape: {spheres, paths, rounds_per_path, ms: {kernel:
    [ms, ...]}, sha256: {kernel: digest}}}."""
    import torch

    from bevy_raytrace_tpu_torch import RenderConfig, scenes
    from bevy_raytrace_tpu_torch.kernels import build, common
    from bevy_raytrace_tpu_torch.kernels import record as k2
    from bevy_raytrace_tpu_torch.kernels import render_lanes as k1
    from bevy_raytrace_tpu_torch.kernels import sweep_record as k4
    from bevy_raytrace_tpu_torch.kernels.clusters import cluster_scene
    from bevy_raytrace_tpu_torch.scenes import random_scene
    from bevy_raytrace_tpu_torch.wavefront.render import frame_seed

    out = {}
    names = ("k1_render", "k4_sweep_record")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build.load, names)))
    limits = {}
    for name, lib in libs.items():
        _, text = build.BUILD_LOG.get(name, (0.0, ""))
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

    from bevy_raytrace_tpu_torch.device import smi_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5,
                    help="interleaved rounds of the forward kernels")
    ap.add_argument("--parts", default="forward,efficiency",
                    help="comma list of the parts to run: forward (K1, K2, "
                         "K4 interleaved), efficiency (K1's lanes under the "
                         "two schedules)")
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    if not torch.cuda.is_available():
        print("forward_kernels: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = smi_line()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    forward = forward_kernels(dev, args.reps) if "forward" in parts else {}
    eff = efficiencies(dev) if "efficiency" in parts else {}
    log(smi)
    log(json.dumps({"device": smi, "forward_kernels": forward,
                    "lane_efficiency": eff}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
