"""Live chunks a round under K1's chunk-culled traversal.

    python -m bevy_raytrace_tpu_torch.tools.livechunks [cluster_size] [spp]
        [max_rounds] [--width W] [--height H] [--depth D] [--device cpu]

Counterpart of `tools/livechunks.py`: the same positional arguments and
defaults (64 32 64) on `rtiow_final_scene(0)` at 1200x800, depth 8
(`max_rounds` 0: every lane to its end).  It
answers how many sphere chunks a ray's bound test keeps live per round,
the share of the chunk sweep the culled traversal still does.

The count is the culled kernel's own (`render_lanes(..., cull=...,
count_live=True)`: each lane's live chunks summed over its rounds), where
the reference read a debug plane of its TPU kernel; `max_rounds` stops every
lane after that many rounds, as there.  The line gives the live chunks over
all rounds and the 90th percentile of the lanes' own means, each also as a
share of the chunk count.  The reference counted a 1,024-lane tile's union,
which the tile's coherence decides; a lane's count here depends on its
pixel only, so it is the same in any layout.  What the layout changes on
the card is how many chunks a warp walks (the union of its lanes'), so the
tool times one culled launch and one dense launch of the same lanes and
rounds (CUDA events, after a warm launch each; host milliseconds on the
CPU) in each of the reference's two layouts: "coherent", the cost-sorted
Morton perm of `balance_perm` over a cost map of the same frame (the
production layout), and "identity", raster order.  With `--device cpu`
the culled twin counts.  `RESULTS` holds the last run's record for a
caller in this process.
"""

from __future__ import annotations

import argparse
import sys
import time

RESULTS: list = []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cluster_size", type=int, nargs="?", default=64)
    ap.add_argument("spp", type=int, nargs="?", default=32)
    ap.add_argument("max_rounds", type=int, nargs="?", default=64)
    ap.add_argument("--width", type=int, default=1200)
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="where to run: the CUDA device by default; 'cpu' "
                         "counts with the culled twin on the CPU")
    args = ap.parse_args(argv)

    import torch

    from bevy_raytrace_tpu_torch import RenderConfig
    from bevy_raytrace_tpu_torch.device import resolve
    from bevy_raytrace_tpu_torch.kernels import render_lanes as k1
    from bevy_raytrace_tpu_torch.kernels.clusters import cluster_scene
    from bevy_raytrace_tpu_torch.scenes import (
        rtiow_final_camera,
        rtiow_final_scene,
    )
    from bevy_raytrace_tpu_torch.wavefront.render import frame_seed

    device = resolve(args.device)
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp, max_depth=args.depth)
    scene, _ = rtiow_final_scene(seed=0, device=device)
    camera = rtiow_final_camera(cfg.aspect, device=device)
    plan = cluster_scene(scene, cluster_size=args.cluster_size)
    print(f"plan: {plan.n_clusters} chunks x {args.cluster_size}", flush=True)

    # The cost map of the frame -> the coherent balanced perm.
    _, len_map = k1.render_mxu_with_len(scene, camera, cfg, plan=plan)
    n = cfg.num_pixels
    tail = torch.arange(n, k1.lane_pad(n), dtype=torch.int32, device=device)
    layouts = {"coherent": torch.cat([k1.balance_perm(len_map), tail]),
               "identity": torch.arange(k1.lane_pad(n), dtype=torch.int32,
                                        device=device)}
    geom, attr, cull = k1._scene_tables(scene, plan)
    dense_geom, dense_attr = k1._scene_tables(scene)

    def launch(pids, dense=False, **kw):
        tables = (dense_geom, dense_attr) if dense else (geom, attr)
        if not dense:
            kw.update(cull=cull, max_rounds=args.max_rounds)
        return k1.render_lanes(
            *tables, camera.pack().contiguous(), pids, frame_seed(cfg, 0),
            0, cfg.samples_per_pixel, cfg.max_depth, cfg.t_min, cfg.width,
            cfg.height, **kw)

    def timed(pids, dense):
        launch(pids, dense)  # warm
        if device.type != "cuda":
            t0 = time.perf_counter()
            launch(pids, dense)
            return (time.perf_counter() - t0) * 1e3
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        launch(pids, dense)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    _, rounds, live = launch(layouts["identity"], count_live=True)
    rounds, live = rounds[:n].double(), live[:n].double()
    mean = float(live.sum() / rounds.sum())
    p90 = float(torch.quantile(live / rounds.clamp(min=1), 0.9))
    c = plan.n_clusters
    print(f"live chunks/round: mean {mean:.2f} / {c} ({mean / c:.2%}), p90 "
          f"of the lanes {p90:.2f} ({p90 / c:.2%}) on {device}", flush=True)
    del RESULTS[:]
    RESULTS.append({"cluster_size": args.cluster_size, "n_clusters": c,
                    "mean_live_chunks": mean, "p90_live_chunks": p90,
                    "rounds": float(rounds.sum()), "device": str(device),
                    "ms": {}, "dense_ms": {}})
    if args.max_rounds:  # the dense launch would run more rounds
        print("dense launch: not timed with max_rounds", flush=True)
    for name, pids in layouts.items():
        ms = RESULTS[0]["ms"][name] = timed(pids, False)
        line = f"{name:9s} culled launch {ms:9.3f} ms"
        if not args.max_rounds:
            dense = RESULTS[0]["dense_ms"][name] = timed(pids, True)
            line += f", dense {dense:9.3f} ms ({dense / ms:.3f}x)"
        print(f"{line} on {device}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
