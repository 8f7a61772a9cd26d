#!/usr/bin/env python3
"""Run one cell of the benchmark of bevy_raytrace_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for.  Prints one JSON line on stdout (`correct`, `attempted`, `failed`,
`metrics`, `device`, with --trace 1 `breakdown`, and last `checks`: each
number compared with its limit); everything else goes to stderr, the checks
last.  Exits nonzero with no result when there is no such card, or when a
module of the JAX package was loaded.  See benchmark/brtbench/main.py.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(_HERE), str(_HERE.parent)]

from brtbench.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
