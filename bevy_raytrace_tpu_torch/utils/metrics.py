"""Per-frame metrics and timing.

Mirror of `bevy_raytrace_tpu/utils/metrics.py` (`RenderMetrics`,
`FrameTimer`).  A frame on a CUDA device is timed to its end: the timer
synchronizes the device before it reads the clock.  `trace_profile` is the
profiler context, on `torch.profiler`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import List, Optional

import torch


def synchronize(out):
    """Wait for the device work that produced `out` (a tensor or a tuple
    holding tensors); no-op for CPU tensors.  Returns `out`."""
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            break
    return out


@dataclasses.dataclass
class RenderMetrics:
    frame_time_s: float
    rays_per_frame: int
    max_depth: int
    n_spheres: int

    @property
    def rays_per_sec(self) -> float:
        return self.rays_per_frame / self.frame_time_s

    @property
    def ray_bounces_per_sec(self) -> float:
        """Upper bound: as if every ray ran every bounce round."""
        return self.rays_per_sec * self.max_depth

    @property
    def sphere_tests_per_sec(self) -> float:
        return self.ray_bounces_per_sec * self.n_spheres

    def line(self) -> str:
        return (
            f"frame {self.frame_time_s * 1e3:8.2f} ms | "
            f"{self.rays_per_sec:12,.0f} rays/s | "
            f"{self.sphere_tests_per_sec:14,.0f} ray-sphere tests/s"
        )


class FrameTimer:
    """Times render steps to their end on the device."""

    def __init__(self, config, n_spheres: int):
        self.config = config
        self.n_spheres = n_spheres
        self.history: List[RenderMetrics] = []

    def time_frame(self, fn, *args, **kw):
        t0 = time.perf_counter()
        out = synchronize(fn(*args, **kw))
        m = RenderMetrics(
            frame_time_s=time.perf_counter() - t0,
            rays_per_frame=self.config.rays_per_frame,
            max_depth=self.config.max_depth,
            n_spheres=self.n_spheres,
        )
        self.history.append(m)
        return out, m

    @property
    def best(self) -> Optional[RenderMetrics]:
        if not self.history:
            return None
        return min(self.history, key=lambda m: m.frame_time_s)


@contextlib.contextmanager
def trace_profile(log_dir: str):
    """Capture a `torch.profiler` trace of the block (CPU, and CUDA when a
    card is present) into `log_dir/trace.json` (open with Perfetto or
    chrome://tracing).  Yields the profiler, whose `key_averages()` give
    per-kernel device times once the block has ended.

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
