"""The traced run's window: ``torch.profiler`` over the measured loop, reduced
to what the per-layer readers and the result line need.

:class:`Window` wraps the loop. With tracing on it records CPU and CUDA
activity and marks the window with a ``portbench.window`` span; runners mark
their calls into the program with :func:`span`. :meth:`Window.view` reduces
the raw events once to a :class:`TraceView`: the device's operations inside
the window (kernels, copies, sets), their union (busy seconds), the idle gaps
labelled by what the host was doing, and the busiest operations.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

import torch

WINDOW_SPAN = "portbench.window"
SPAN_PREFIX = "portbench."
# the port's own kernels (csrc/*.cu), by file; every other kernel is a torch
# op's or a library's
_NS = r"^(void )?(\(anonymous namespace\)::)?"
PORT_KERNELS = {
    "qstage": re.compile(_NS + r"conv_kernel\b"),
    "nystrom": re.compile(_NS + r"(landmark_attn_kernel|query_lm_kernel)\b"),
    "translayer": re.compile(_NS + r"(ln_stats_kernel|split_kernel|gemm_kernel)\b"),
}


def span(name: str):
    """A host span around a call into the program (a no-op when no profiler
    runs)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


@dataclass
class TraceView:
    window_s: float
    ops: list  # (name, start_s, dur_s) of each device operation in the window
    busy_s: float
    gaps: dict = field(default_factory=dict)  # host label -> idle seconds

    def total_s(self, pred) -> float:
        return sum(d for name, _, d in self.ops if pred(name))

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = defaultdict(float)
        for name, _, d in self.ops:
            by_name[short_name(name)] += d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def is_copy(name: str, kind: str = "") -> bool:
    return name.startswith("Memcpy") and kind in name


def is_set(name: str) -> bool:
    return name.startswith("Memset")


def is_port(name: str, file: str | None = None) -> bool:
    pats = [PORT_KERNELS[file]] if file else PORT_KERNELS.values()
    return any(p.match(name) for p in pats)


def is_torch_op(name: str) -> bool:
    """A kernel that is neither the port's own nor a copy or a set."""
    return not (is_copy(name) or is_set(name) or is_port(name))


def short_name(name: str, limit: int = 120) -> str:
    name = re.sub(_NS, "", name)
    return name if len(name) <= limit else name[:limit - 3] + "..."


class Window:
    """Context manager around the measured loop; ``enabled`` False costs
    nothing."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self._prof = None

    def __enter__(self) -> "Window":
        if self.enabled:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self._span = torch.profiler.record_function(WINDOW_SPAN)
            self._span.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._prof is not None:
            torch.cuda.synchronize()
            self._span.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)

    def view(self) -> TraceView | None:
        """The window's events reduced (None when tracing was off)."""
        if self._prof is None:
            return None
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        return reduce_events(events)


def _is_annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else False


def _host_label(stack: list) -> str:
    """``<innermost benchmark span> / <innermost other host op>``."""
    mine = [n for n in stack if n.startswith(SPAN_PREFIX) and n != WINDOW_SPAN]
    other = [n for n in stack if not n.startswith(SPAN_PREFIX)]
    outer = mine[-1][len(SPAN_PREFIX):] if mine else "window"
    return f"{outer} / {other[-1]}" if other else outer


def reduce_events(events) -> TraceView:
    """Reduce raw kineto events: the window is the ``portbench.window``
    span; device operations are clipped to it."""
    host, dev = [], []
    w0 = w1 = None
    for e in events:
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # a host span mirrored on the device's timeline is no operation
            if not (name.startswith(SPAN_PREFIX) or _is_annotation(e)):
                dev.append((name, start, dur))
        elif name == WINDOW_SPAN:
            w0, w1 = start, start + dur
        elif dur > 0:
            host.append((start, start + dur, name))
    if w0 is None:
        raise RuntimeError("the trace holds no window span")
    ops = []
    for name, s, d in dev:
        a, b = max(s, w0), min(s + d, w1)
        if b > a:
            ops.append((name, (a - w0) / 1e9, (b - a) / 1e9))
    ops.sort(key=lambda o: o[1])
    # the union of device intervals, and the gaps between them
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for _, s, d in ops:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            elif s > 0:
                gaps.append((0.0, s))
            cur_s, cur_e = s, s + d
        else:
            cur_e = max(cur_e, s + d)
    window_s = (w1 - w0) / 1e9
    if cur_e is not None:
        busy += cur_e - cur_s
        if cur_e < window_s:
            gaps.append((cur_e, window_s))
    return TraceView(window_s=window_s, ops=ops, busy_s=busy,
                     gaps=_label_gaps(gaps, host, w0))


def _label_gaps(gaps: list, host: list, w0: int) -> dict:
    """Sum each idle gap (>= 20 us) under the host ops open at its start."""
    host = sorted((s, e, n) for s, e, n in host)
    out: dict = defaultdict(float)
    hi = 0
    open_ops: list = []
    for g0, g1 in gaps:
        if g1 - g0 < 20e-6:
            continue
        t = w0 + int(g0 * 1e9)
        while hi < len(host) and host[hi][0] <= t:
            open_ops.append(host[hi])
            hi += 1
        open_ops = [o for o in open_ops if o[1] > t]
        stack = [n for _, _, n in sorted(open_ops)]
        out[_host_label(stack)] += g1 - g0
    return dict(out)

