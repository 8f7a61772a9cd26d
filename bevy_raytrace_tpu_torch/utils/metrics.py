"""Waiting for the device, and the operator's profiler context.

`synchronize` waits for the device work behind a result.  `trace_profile`
is the profiler context, on `torch.profiler`: it writes the trace and the
port's spans and counters of the block (`utils/spans.py`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os

import torch

from bevy_raytrace_tpu_torch.utils import spans


def synchronize(out):
    """Wait for the device work that produced `out` (a tensor or a tuple
    holding tensors); no-op for CPU tensors.  Returns `out`."""
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            break
    return out


@contextlib.contextmanager
def trace_profile(log_dir: str):
    """Capture a `torch.profiler` trace of the block (CPU, and CUDA when a
    card is present) into `log_dir/trace.json` (open with Perfetto or
    chrome://tracing), and the port's spans and counters into
    `log_dir/spans.json` (`{"spans": [records], "counters": {...}}`, times
    in `spans.clock` ns); the spans written are cleared.  Yields the
    profiler, whose `key_averages()` give per-kernel device times once the
    block has ended.

    Usage:
        with trace_profile("out/trace") as prof:
            img = step(scene, camera, config, 0)
        print(prof.key_averages().table(sort_by="cuda_time_total"))
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"spans": [dataclasses.asdict(r) for r in spans.spans()],
                   "counters": spans.counters()}, f)
    spans.clear_spans()
