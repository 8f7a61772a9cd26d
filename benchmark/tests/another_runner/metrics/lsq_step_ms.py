"""lsq_step_ms: the median step of the window, in ms."""

import numpy as np


def read(run):
    return float(np.median(run.latencies_s)) * 1e3
