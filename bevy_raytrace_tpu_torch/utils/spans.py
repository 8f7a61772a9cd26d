"""The port's in-memory recorder: spans of host work, and named counters.

`span(name)` times a block of host work while a `torch.profiler` is running
(`torch.autograd.profiler._is_profiler_enabled`): a benchmark's traced
window, an operator's `trace_profile` block.  With no profiler running a
span reads that flag and records nothing.  A record (`SpanRecord`) holds

- `name`;
- `t0_ns`, `t1_ns`: its start and end on `clock`, which is
  `time.perf_counter_ns`, the clock of the benchmark runner's marks and of
  its launch marker: a span lands on the device trace by the offset that
  places those, `t + (first device event - marker_ns)`;
- `parent`: the index in `spans()` of the enclosing open span of the same
  thread, None at the top (a span opened on another thread, such as
  `Renderer.warmup_async`'s, never nests under this thread's);
- `frame`: the session frame the span belongs to, set by the session's
  `session.frame` span and inherited by the spans inside it; None outside
  a frame.

`spans()` returns the records in the order they were opened (an open span's
`t1_ns` is None); `clear_spans()` drops them, and is called with no span
open.

`count(name, n)` adds to a named counter whether or not a profiler runs.
The kernels' wrappers count their launches here under dotted names
(`k1.launches`, `k1.launches_global`, `k1.launches_culled`, `k2.launches`,
`k2.launches_clustered`, `k3.launches`, `k3.launches_global`,
`k4.launches`, `k4.launches_global`, `p1.launches` ... `p5.launches`,
`v1.launches` ... `v3.launches`); `counter`, `counters` and
`reset_counters` read and zero them.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import torch.autograd.profiler as _profiler

clock = time.perf_counter_ns


@dataclasses.dataclass
class SpanRecord:
    name: str
    t0_ns: int
    t1_ns: Optional[int]
    parent: Optional[int]
    frame: Optional[int]


_records: list = []
_records_lock = threading.Lock()
_local = threading.local()  # .stack: [(record index, frame)] of open spans
_counters: dict = {}
_counters_lock = threading.Lock()  # a count is a read, an add and a store


class _Off:
    """What `span` gives while no profiler runs: a block that records
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "frame", "_rec", "_stack")

    def __init__(self, name, frame):
        self.name = name
        self.frame = frame
        self._rec = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent, frame = stack[-1] if stack else (None, None)
        if self.frame is not None:
            frame = self.frame
        rec = SpanRecord(self.name, clock(), None, parent, frame)
        with _records_lock:
            index = len(_records)
            _records.append(rec)
        stack.append((index, frame))
        self._rec, self._stack = rec, stack
        return self

    def __exit__(self, *exc):
        self._rec.t1_ns = clock()
        self._stack.pop()
        return False


def span(name: str, frame: Optional[int] = None):
    """`with span(name[, frame=n]):` records the block while a profiler
    runs; `frame` marks a session frame for the spans inside it."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, frame)


def spans() -> list:
    """The records since the last `clear_spans()`, in opening order."""
    with _records_lock:
        return list(_records)


def clear_spans() -> None:
    with _records_lock:
        _records.clear()


def count(name: str, n: int = 1) -> None:
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    return _counters.get(name, 0)


def counters(prefix: str = "") -> dict:
    """{name: count} of the counters whose name starts with `prefix`."""
    with _counters_lock:
        return {k: v for k, v in _counters.items() if k.startswith(prefix)}


def reset_counters(prefix: str = "") -> None:
    """Zero every counter whose name starts with `prefix`."""
    with _counters_lock:
        for k in [k for k in _counters if k.startswith(prefix)]:
            del _counters[k]
