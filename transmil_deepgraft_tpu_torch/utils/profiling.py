"""Profiling: spans and counters inside the port, and ``torch.profiler``
traces (port of ``utils/profiling.py``).

The port marks its layers with :func:`span` (``with span("backbone.stem"):``)
and counts with :func:`count`. Both are switched by the profiler itself:
while no ``torch.profiler`` records in the process, a span is one read of
the profiler's own flag and a shared no-op. While one records, a span is a
``record_function("tdg.<name>")`` range (on the trace's clock, in every
Chrome trace) and it adds its calls, host seconds and, on a CUDA device,
stream seconds (a pair of timing events on the current stream) to the
process's registry; a counter adds to it. :func:`snapshot` reads the
registry, which holds exactly the current or the last profiled region: a
profiler's start empties it.

``trace()`` wraps a region in a ``torch.profiler`` trace (CPU and, where
there is a card, CUDA activities) and writes it as a Chrome trace
(``trace.json``, for Perfetto or chrome://tracing) into ``log_dir``, with
the region's spans and counters beside it (``spans.json``).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import deque
from pathlib import Path

import torch
import torch.autograd.profiler as _autograd_profiler

PREFIX = "tdg."  # span names in a trace: tdg.<layer>.<part>
# timed event pairs left unresolved; past this many the finished ones are
# resolved together (one query each), so a span's exit adds no device call
MAX_PENDING = 256

_NOOP = contextlib.nullcontext()


if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def enabled() -> bool:
        """True while a ``torch.profiler`` records in this process."""
        return _autograd_profiler._is_profiler_enabled
else:  # a torch without the Python-side flag: ask the profiler itself
    enabled = torch._C._autograd._profiler_enabled


class _Registry:
    """Calls, host and stream seconds of each span and the counters, of one
    profiled region. Safe across threads (the dispatcher, prefetch and
    autograd threads add to it)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._spans: dict[str, list] = {}  # name -> [calls, host_s, device_s]
        self._counters: dict[str, int] = {}
        self._pending: deque = deque()  # (name, start event, end event)

    def reset(self) -> None:
        with self._lock:
            self._spans, self._counters = {}, {}
            self._pending.clear()

    @staticmethod
    def mark():
        """A timing event recorded on the current stream, or None when CUDA
        is not in use in this process."""
        if not torch.cuda.is_initialized():
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def add_span(self, name: str, host_s: float, device_s: float = 0.0, calls: int = 1) -> None:
        with self._lock:
            entry = self._spans.setdefault(name, [0, 0.0, 0.0])
            entry[0] += calls
            entry[1] += host_s
            entry[2] += device_s

    def add_timed(self, name: str, host_s: float, start, end) -> None:
        """A span's host seconds and its two marks, resolved later."""
        self.add_span(name, host_s)
        with self._lock:
            self._pending.append((name, start, end))
            if len(self._pending) > MAX_PENDING:
                self._resolve()
                if len(self._pending) > MAX_PENDING:  # the device is that far behind
                    self._pending[0][2].synchronize()
                    self._resolve()

    def count(self, name: str, k: int) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(k)

    def _resolve(self) -> None:
        """Add the stream seconds of the finished pairs, oldest first. Under
        the lock."""
        while self._pending:
            name, start, end = self._pending[0]
            if not end.query():
                return
            self._pending.popleft()
            entry = self._spans.get(name)
            if entry is not None:
                entry[2] += start.elapsed_time(end) / 1e3

    def snapshot(self) -> dict:
        with self._lock:
            for *_, end in self._pending:
                end.synchronize()
            self._resolve()
            return {"spans": {n: {"calls": c, "host_s": h, "device_s": d}
                              for n, (c, h, d) in self._spans.items()},
                    "counters": dict(self._counters)}


REGISTRY = _Registry()


class _Span:
    __slots__ = ("name", "_range", "_t0", "_start")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "_Span":
        self._range = torch.profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        self._start = REGISTRY.mark()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        host_s = time.perf_counter() - self._t0
        if self._start is None:
            REGISTRY.add_span(self.name, host_s)
        else:
            REGISTRY.add_timed(self.name, host_s, self._start, REGISTRY.mark())
        self._range.__exit__(*exc)


def span(name: str):
    """``with span("slide.copy"):`` a region of the port's work, recorded
    while a profiler runs (see the module's docstring)."""
    if not enabled():
        return _NOOP
    return _Span(name)


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the counter ``name`` while a profiler runs."""
    if enabled():
        REGISTRY.count(name, k)


def snapshot() -> dict:
    """``{"spans": {name: {"calls", "host_s", "device_s"}}, "counters":
    {name: n}}`` of the current or last profiled region; waits for the
    device where stream times are outstanding."""
    return REGISTRY.snapshot()


def device_allocs(device: torch.device) -> int:
    """The caching allocator's device allocations (``cudaMalloc`` calls) on
    ``device`` so far; 0 off CUDA."""
    if device.type != "cuda":
        return 0
    stats = torch.cuda.memory_stats(device)
    return int(stats.get("num_device_alloc", stats.get("segment.all.allocated", 0)))


# every profiler start begins a new region: wrap the hook the profiler calls
# as it turns its flag on. A torch without that hook keeps adding to the
# registry across regions.
if hasattr(_autograd_profiler, "_run_on_profiler_start"):
    _on_start = _autograd_profiler._run_on_profiler_start

    def _run_on_profiler_start() -> None:
        REGISTRY.reset()
        _on_start()

    _autograd_profiler._run_on_profiler_start = _run_on_profiler_start


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str | Path = "logs/profile"):
    """torch.profiler trace of the region -> ``log_dir/trace.json``, and its
    spans and counters -> ``log_dir/spans.json``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            _sync()
    prof.export_chrome_trace(str(log_dir / "trace.json"))
    (log_dir / "spans.json").write_text(json.dumps(snapshot(), indent=1))
