#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card, in one process.

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,... \
        [--seconds 3] [--fault <name>]

For each seed: one run of the cell as `run.py` makes it, with a short
window at the cell's own load and the same check (the program's numbers:
the lower readings), and the control put in the program's place on the
same inputs (the upper readings).  The cell's runner names the numbers
(`NUMBERS`) and makes the control: for the `session` runner, the plain
reference at bfloat16, the precision below the float32 the configuration
states.  One JSON line a seed on stdout, then one with the largest program
reading and the smallest control reading of each number.  With --fault,
each run plants that fault of the runner's `FAULTS` (for `session`:
stale, half, bright, block, brtbench/faults.py) in the program's session
instead and runs no control: one line a seed, then one with the smallest
reading of each number and whether every run came out not correct.  The
benchmark's own runs run neither.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(_HERE), str(_HERE.parent)]

from brtbench import spec  # noqa: E402


def main(argv=None, device=None, make_session=None, sync=None):
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", help="a fault of the cell's runner")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    runner = spec.runner(cell.traffic["runner"])
    if args.fault is not None and args.fault not in runner.FAULTS:
        p.error(f"argument --fault: invalid choice: {args.fault!r} (choose "
                f"from {', '.join(sorted(runner.FAULTS))})")
    if device is None:
        if not torch.cuda.is_available():
            print("needs a CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    if args.fault:
        make_session = runner.FAULTS[args.fault](
            make_session or runner.default_session)
    lower = {k: 0.0 for k in runner.NUMBERS}
    upper = {k: float("inf") for k in runner.NUMBERS}
    least = dict(upper)
    every_fails = True
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = runner.run(cell, seed, args.seconds, False, device,
                         time.perf_counter(), make_session=make_session,
                         sync=sync, control=not args.fault)
        for k in runner.NUMBERS:
            lower[k] = max(lower[k], rec.stats[k])
            least[k] = min(least[k], rec.stats[k])
            if not args.fault:
                upper[k] = min(upper[k], rec.control_stats[k])
        every_fails = every_fails and not rec.correct
        print(json.dumps({"seed": seed, "frames": rec.attempted,
                          "program": rec.stats, "control": rec.control_stats,
                          "correct": rec.correct}), flush=True)
    if args.fault:
        print(json.dumps({"workload": cell.name, "fault": args.fault,
                          "least": least, "every_run_not_correct":
                          every_fails}), flush=True)
    else:
        print(json.dumps({"workload": cell.name, "lower": lower,
                          "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
