"""One run of one cell: set-up, the measured window, the check, one line.

With --trace 0 the line's metrics are the cell's end-to-end metrics; with
--trace 1 the window runs under the profiler and the metrics are the
cell's per-layer metrics, with the device's busy time, the window's length
and the breakdown.  Each metric is read from the run's record by
`benchmark/metrics/<name>.py`; a per-layer reader that finds nothing to
read returns None and the metric is left out.  `setup_s` runs from the top
of `run.py` (the interpreter's own start, some tens of milliseconds, is
not in it) to the first timed item of work.

A mix's runner is `benchmark/runners/<runner>.py`, found by the name the
mix gives.  Everything that is particular to one kind of work and its check
is the runner's, so that a cell of a new kind is new files only.  A runner
module declares:

- `STEPS`: the host steps of one item of its work (a frame, an optimizer
  step), in order;
- `NUMBERS`: the names of the numbers its check compares, in the order the
  record's `checks` lists them; a cell file's `limits` has exactly these
  keys;
- `FAULTS`: {name: plant(make_session) -> make_session}, the faults its
  timed path can have, each of which its check must find
  (`readings.py --fault`);
- `validate(cell)`: raises ValueError on a cell file or mix it cannot run;
  `run` calls it before any set-up;
- `default_session(config, device)`: the program's session on the card;
- `run(cell, seed, seconds, trace, device, t_start, make_session=,
  sync=, control=False)`: one run.  It returns a record that holds at
  least `setup_s`, `window_s`, `attempted`, `failed`, `correct`, `checks`
  ([(name, value, limit)] in `NUMBERS`' order), `stats` (each of
  `NUMBERS` by name), with `control` `control_stats` (the same numbers of
  the control put in the program's place), `latencies_s` (one an item),
  `marks` (int64 [items, len(STEPS) + 1]: when each step began, and when
  the last ended), `setup_parts`, `memory_peak_bytes`, `trace`
  (tracing.Trace or None; a Trace when traced), `reduce_s` and `check_s`;
  the metric readers read the rest.

Its CPU rehearsal is `benchmark/tests/rehearse_<runner>.py` (spec.
rehearsal), which gives `tiny_cell(name, fault=None)` (the cell at a size
the CPU holds, at the size a fault needs to show), `make_session` (a
session of the program's plain paths on CPU tensors), `sync()` and
`trace(monkeypatch, runner)` (what a traced run on the CPU needs); the
harness's generic tests drive every cell through it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np

from brtbench import guard, spec


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit_w():
    """The card's power limit from nvidia-smi, None if it cannot say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(cell, rec, trace: bool, device_info: dict) -> dict:
    """The JSON object the run prints, from its record."""
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"])(rec)
        if value is None:
            if not trace:
                raise RuntimeError(f"no value for {m['name']}")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": bool(rec.correct), "attempted": rec.attempted,
           "failed": rec.failed, "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = rec.trace.busy_s
        device_info["window_s"] = rec.trace.window_s
        out["breakdown"] = rec.trace.breakdown()
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in rec.checks}
    return out


def main(argv, t_start: float, device=None, make_session=None,
         sync=None) -> int:
    """Run the cell; `device` None means the CUDA card (required).  Tests
    pass a CPU device and a session of the program's plain paths."""
    import torch

    args = parse(argv)
    cell = spec.load_cell(args.workload)
    if device is None:
        if not torch.cuda.is_available() or (
                torch.cuda.device_count() < cell.chips):
            log(f"{cell.name} needs {cell.chips} CUDA device(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    runner = spec.runner(cell.traffic["runner"])
    rec = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                     device, t_start, make_session=make_session, sync=sync)
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": cell.chips, "memory_peak_bytes": rec.memory_peak_bytes,
                "power_limit_w": power_limit_w()}
    else:
        info = {"platform": device.type, "kind": device.type, "count": 1,
                "memory_peak_bytes": rec.memory_peak_bytes}
    out = result_line(cell, rec, bool(args.trace), info)
    bad = guard.forbidden_modules()
    if bad:
        log(f"modules of the JAX package were loaded: {', '.join(bad)}")
        return 3
    log(f"[{cell.name}] seed {args.seed}: {rec.attempted} items in "
        f"{rec.window_s:.3f} s after {rec.setup_s:.3f} s of set-up; trace "
        f"read in {rec.reduce_s:.3f} s, reference in {rec.check_s:.3f} s; "
        f"correct {rec.correct}; {json.dumps(rec.stats)}")
    lat = np.asarray(rec.latencies_s) * 1e3
    steps = np.diff(np.asarray(rec.marks, np.float64), axis=1).mean(0)
    log("item ms: p5 {:.4f} p50 {:.4f} p95 {:.4f} p99 {:.4f} max {:.4f} "
        "mean {:.4f}; host steps an item ({}): {} ms".format(
            *np.percentile(lat, [5, 50, 95, 99]), lat.max(), lat.mean(),
            ", ".join(runner.STEPS),
            " ".join(f"{v:.4f}" for v in steps * 1e-6)))
    log("set-up, seconds from the start: " + ", ".join(
        f"{k} {v:.3f}" for k, v in (rec.setup_parts or {}).items()))
    for name, v, lim in rec.checks:
        log(f"check {name} {v!r} limit {lim!r}")
    print(json.dumps(out), flush=True)
    return 0
