"""The harness's CPU tests: the benchmark's folder and the repository root
on the path, the port on the CPU, and a session of the port's plain paths
(K1's twin) in place of the CUDA session."""

import sys
from pathlib import Path

import torch

_BENCH = Path(__file__).resolve().parent.parent
for p in (str(_BENCH), str(_BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

torch.set_num_threads(2)
