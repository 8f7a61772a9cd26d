"""Runner "lsq": gradient steps of a seeded least-squares problem.

A toy runner whose items are optimizer steps, not frames, with a check of
its own; it stands for a runner of another kind in the test that adds one
with new files only.  Set-up draws A [rows, cols], b [rows] and the start
x0 from the seed on the device, opens the program's session and takes
`warmup_steps` steps.  A step asks the session for the gradient of
mean((A x - b)^2) at x and moves x by `lr` times it.  The window steps
until `--seconds` have passed and keeps the gradients of its first `steps`
steps (the cell file).  After the window the plain reference retraces
every step from x0 in float64, and the check compares each kept gradient
with the reference's at the same step: `grad_max_rel`, the largest
element's gap over the reference's largest element.  The control is that
reference in bfloat16.  A traced run reads the host's clock: the gradient
steps are its busy time.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from brtbench import tracing

STEPS = ("gradient", "update")
NUMBERS = ("grad_max_rel",)
MIX_KEYS = {"runner", "rows", "cols", "lr", "warmup_steps"}


class Session:
    """The program: the gradient by autograd, in float32."""

    def __init__(self, problem, device):
        self.a, self.b = problem

    def gradient(self, x):
        x = x.detach().requires_grad_(True)
        loss = ((self.a @ x - self.b) ** 2).mean()
        return torch.autograd.grad(loss, x)[0]


def default_session(problem, device):
    return Session(problem, device)


class _Stale:
    """A step that returns its state unchanged: the first gradient again."""

    def __init__(self, inner):
        self.inner, self.g = inner, None

    def gradient(self, x):
        if self.g is None:
            self.g = self.inner.gradient(x)
        return self.g


class _Scaled:
    """An answer altered where it is produced: 2% too large."""

    def __init__(self, inner):
        self.inner = inner

    def gradient(self, x):
        return self.inner.gradient(x) * 1.02


def _half(make_session):
    """Half of the batch left out, the mean over the rest."""
    def make(problem, device):
        a, b = problem
        return make_session((a[: a.shape[0] // 2], b[: b.shape[0] // 2]),
                            device)

    return make


def _wrap(kind):
    def plant(make_session):
        return lambda problem, device: kind(make_session(problem, device))

    return plant


FAULTS = {"stale": _wrap(_Stale), "half": _half, "scaled": _wrap(_Scaled)}


def validate(cell) -> None:
    unknown = set(cell.traffic) - MIX_KEYS
    if unknown:
        raise ValueError(f"traffic mix {cell.traffic_name!r}: the lsq "
                         f"runner reads no {sorted(unknown)}")
    if set(cell.check["limits"]) != set(NUMBERS):
        raise ValueError(f"cell {cell.name!r}: limits "
                         f"{sorted(cell.check['limits'])}, the lsq check "
                         f"compares {list(NUMBERS)}")


@dataclasses.dataclass
class Record:
    setup_s: float
    window_s: float
    frames: int  # steps, as `rays_per_s` counts items
    paths_per_frame: int  # rows a step
    latencies_s: list
    marks: object
    memory_peak_bytes: int
    trace: object
    stats: dict
    checks: list
    correct: bool
    attempted: int
    failed: int
    control_stats: dict = None
    setup_parts: dict = None
    reduce_s: float = 0.0
    check_s: float = 0.0


def _reference(a, b, x0, lr, n, dtype):
    """The gradients of n plain steps from x0, computed in `dtype`."""
    a, b, x = a.to(dtype), b.to(dtype), x0.to(dtype)
    out = []
    for _ in range(n):
        g = (a.T @ (a @ x - b)) * (2.0 / a.shape[0])
        out.append(g.to(torch.float64))
        x = x - lr * g
    return out


def _stats(prog, ref):
    gap = max(float((p - r).abs().max() / r.abs().max())
              for p, r in zip(prog, ref))
    return {"grad_max_rel": gap, "finite": math.isfinite(gap)}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        make_session=None, sync=None, control: bool = False) -> Record:
    validate(cell)
    mix, device = cell.traffic, torch.device(device)
    sync = sync or (lambda: torch.cuda.synchronize(device))
    rows, cols, lr = int(mix["rows"]), int(mix["cols"]), float(mix["lr"])
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    a = torch.randn(rows, cols, generator=gen, device=device)
    b = torch.randn(rows, generator=gen, device=device)
    x0 = torch.randn(cols, generator=gen, device=device)
    session = (make_session or default_session)((a, b), device)
    x = x0.clone()
    warm = int(mix["warmup_steps"])
    for _ in range(warm):
        x = x - lr * session.gradient(x)
    sync()
    parts = {"warmup": time.perf_counter() - t_start}
    keep, marks = [], []
    clock = time.perf_counter_ns
    setup_s = time.perf_counter() - t_start
    t0 = clock()
    limit = t0 + int(seconds * 1e9)
    while True:
        t_grad = clock()
        g = session.gradient(x)
        t_upd = clock()
        x = x - lr * g
        sync()
        t_done = clock()
        marks.append((t_grad, t_upd, t_done))
        if len(keep) < int(cell.check["steps"]):
            keep.append(g.clone())
        if t_done >= limit:
            break
    marks = np.array(marks, np.int64)
    window_s = (t_done - t0) * 1e-9
    tr = None
    if trace:
        busy = float((marks[:, 1] - marks[:, 0]).sum()) * 1e-9
        tr = tracing.Trace(window_s, busy,
                           {"lsq.gradient": (busy, len(marks))},
                           {"update": window_s - busy})
    peak = (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
    del session
    t_check = time.perf_counter()
    n = warm + len(keep)
    ref = _reference(a, b, x0, lr, n, torch.float64)[warm:]
    stats = _stats(keep, ref)
    limits = cell.check["limits"]
    rows_out = [(k, stats[k], float(limits[k])) for k in NUMBERS]
    correct = stats["finite"] and all(v <= lim for _, v, lim in rows_out)
    ctl = (_stats(_reference(a, b, x0, lr, n, torch.bfloat16)[warm:], ref)
           if control else None)
    return Record(
        setup_s=setup_s, window_s=window_s, frames=len(marks),
        paths_per_frame=rows, latencies_s=((marks[:, 2] - marks[:, 0]) * 1e-9
                                           ).tolist(),
        marks=marks, memory_peak_bytes=peak, trace=tr, stats=stats,
        checks=rows_out, correct=correct, attempted=len(marks), failed=0,
        control_stats=ctl, setup_parts=parts,
        check_s=time.perf_counter() - t_check)
