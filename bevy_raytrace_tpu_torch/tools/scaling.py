"""The sharding record: collectives per sharded step, images and gradients
against the single-process ones, and the sharded workload's times at
several world sizes.

    python -m bevy_raytrace_tpu_torch.tools.scaling [--device cpu]
        [--worlds 1 2 4] [--width W --height H] [--trace-dir DIR]
        [--out FILE]

Counterpart of `tools/scaling.py`.  The reference proves its scaling from
the compiled HLO text (`audit_collectives`); eager PyTorch has none, so the
port's proof is what `shard/worker.py` counts at run time by wrapping
`torch.distributed.all_reduce` / `all_gather`: the collectives of every
sharded forward (none without `gather`), the all-reduces of each backward
(one), and the fast backward's payload, the [S, 11] table cotangent and the
16 camera scalars in float32: (11 S + 16) x 4 bytes (21,448 B on the RTiOW
final scene's 486 spheres).

For each world size the tool starts that many `shard.worker` ranks, one
process each: on the CPU (`--device cpu`) over gloo; by default on the
CUDA devices over nccl, one per device, where a world larger than
`torch.cuda.device_count()` is left out (a log line says so).  Each rank
holds its images bit-identical and its gradients equal to the
single-process ones at `--width` x `--height` or raises.  Then it times
the sharded workload on the RTiOW final scene (the bench's flagship frame,
1200x800x256 depth 8, on the card; 64x32x2 depth 3 on the CPU): K1's
sharded forward and the sharded fast-gradient step (K2 culled, K3, one
all-reduce), the best of REPEATS runs, each begun after a barrier.
`summarize`, the counterpart of `audit_collectives`, folds the ranks'
lines into the world's record; a run ends when its slowest rank does.  The
world-1 run writes one `trace_profile` trace of a sharded gradient step to
`--trace-dir`.

Times on the CPU are a structure check only: the ranks of one host share
its cores, so they are not an efficiency signal (the reference's caveat).

Writes the record to `--out` (default `SCALING_torch.json`; the reference's
`SCALING.json` is never written) and prints it as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

CAVEAT = ("times on shared CPU cores are a structure check only: the "
          "ranks share the host's cores, so they are no efficiency signal")
# The timed shape (width, height, spp, depth): the bench's flagship frame on
# the card, a few pixels on the CPU.
CARD_STEP = (1200, 800, 256, 8)
CPU_STEP = (64, 32, 2, 3)
REPEATS = 3


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def summarize(reports) -> dict:
    """The rank lines of one world (`shard.worker`'s JSON, rank order) ->
    the world's record.  Raises ValueError when a forward counted a
    collective, when a backward did not count exactly one all-reduce of one
    payload, or when two ranks disagree on what they counted or timed."""
    if not reports:
        raise ValueError("no rank reported")
    counted = ("spheres", "forward_collectives",
               "wavefront_backward_all_reduces", "fast_backward_all_reduces",
               "all_reduce_bytes")
    first = reports[0]
    for r in reports[1:]:
        for key in counted:
            if r[key] != first[key]:
                raise ValueError(f"rank {r['rank']} counted {key} = "
                                 f"{r[key]}, rank {first['rank']} "
                                 f"{first[key]}")
    if first["forward_collectives"] != 0:
        raise ValueError(f"a sharded forward called "
                         f"{first['forward_collectives']} collectives")
    per_backward = set(first["fast_backward_all_reduces"])
    if (per_backward != {1} or first["wavefront_backward_all_reduces"] != 1
            or len(first["all_reduce_bytes"]) != 1):
        raise ValueError(
            f"a backward must all-reduce once, one payload: fast "
            f"{first['fast_backward_all_reduces']}, wavefront "
            f"{first['wavefront_backward_all_reduces']}, payloads "
            f"{first['all_reduce_bytes']}")
    record = {
        "world": len(reports), "backend": first["backend"],
        "devices": [r["device"] for r in reports],
        "spheres": first["spheres"],
        "forward_collectives": {"count": 0, "bytes": 0},
        "backward_collectives": {
            "wavefront_all_reduces": 1, "fast_all_reduces": 1,
            "fast_bytes": first["all_reduce_bytes"][0],
            "fast_backwards_counted": len(first["fast_backward_all_reduces"])},
        "matches_single_process": all(r["ok"] for r in reports),
    }
    if "timed" in first:
        timed = [r["timed"] for r in reports]
        for r, t in zip(reports[1:], timed[1:]):
            for key in ("shape", "paths", "spheres", "all_reduce_bytes"):
                if t[key] != timed[0][key]:
                    raise ValueError(f"rank {r['rank']} timed {key} = "
                                     f"{t[key]}, rank {first['rank']} "
                                     f"{timed[0][key]}")

        def best(key):
            # Run i ends when its slowest rank does; the best run counts.
            return min(map(max, zip(*(t[key] for t in timed))))

        paths, frame_s, step_s = timed[0]["paths"], best("frame_s"), best(
            "step_s")
        record["timed"] = {
            "shape": timed[0]["shape"], "paths": paths,
            "spheres": timed[0]["spheres"],
            "fast_bytes": timed[0]["all_reduce_bytes"],
            "frame_s": frame_s, "rays_per_s": paths / frame_s,
            "step_s": step_s, "paths_per_s": paths / step_s,
            "frame_s_by_rank": [t["frame_s"] for t in timed],
            "step_s_by_rank": [t["step_s"] for t in timed]}
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the ranks on the CPU over gloo; "
                         "default: the CUDA devices over nccl")
    ap.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=32)
    ap.add_argument("--trace-dir", default="SCALING_torch_trace",
                    help="where the world-1 run writes trace.json; '' for "
                         "none")
    ap.add_argument("--out", default="SCALING_torch.json")
    args = ap.parse_args(argv)

    import torch

    from bevy_raytrace_tpu_torch.device import resolve
    from bevy_raytrace_tpu_torch.shard.worker import launch_ranks

    device = resolve(args.device)
    cards = torch.cuda.device_count() if device.type == "cuda" else None
    step = CARD_STEP if cards is not None else CPU_STEP
    worlds = []
    for n in args.worlds:
        if cards is not None and n > cards:
            log(f"world {n} left out: {cards} CUDA device(s)")
            continue
        trace = args.trace_dir if n == 1 and args.trace_dir else None
        extra = ["--width", str(args.width), "--height", str(args.height),
                 "--step", *map(str, step), "--repeats", str(REPEATS)]
        record = summarize(launch_ranks(
            n, device, extra + (["--trace-dir", trace] if trace else [])))
        record["trace"] = trace and os.path.join(trace, "trace.json")
        worlds.append(record)
        t = record["timed"]
        log(f"world {n} ({record['backend']}): forward collectives 0, one "
            f"all-reduce of {record['backward_collectives']['fast_bytes']} "
            f"B per fast backward ({record['spheres']} spheres), "
            f"{t['fast_bytes']} B on the timed scene ({t['spheres']}); at "
            f"{'x'.join(map(str, step))}: frame {t['frame_s']:.4f}s "
            f"({t['rays_per_s']:,.0f} rays/s), gradient step "
            f"{t['step_s']:.4f}s ({t['paths_per_s']:,.0f} paths/s)")
    width, height, spp, depth = step
    out = {
        "workload": f"self-check at {args.width}x{args.height}x2spp depth 3 "
                    f"on baseline_config2; timed: {width}x{height}x{spp}spp "
                    f"depth {depth} on the RTiOW final scene, "
                    f"K1's sharded forward and the sharded fast-gradient "
                    f"step (K2 culled at cluster size 12, K3, one "
                    f"all-reduce), best of {REPEATS}",
        "host": f"{os.cpu_count()} cores, "
                + (f"{cards} CUDA device(s), nccl" if cards is not None
                   else "CPU ranks over gloo"),
        "caveat": CAVEAT if cards is None else None,
        "worlds": worlds,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
