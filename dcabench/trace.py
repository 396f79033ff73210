"""One job under ``torch.profiler``, reduced to what the per-layer metrics
and the ``breakdown`` read: the device's busy time (the union of the
intervals in which an operation ran on the card) over the job and inside
each of the benchmark's spans, the operations that took the most device
time, and the idle gaps, each named by the innermost span open on the host
at that moment.

The profile covers one job only: on the card's machine the profiler has
dropped kernel records at the end of profiles of 10^4-10^5 kernels.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

from .jobs import SPAN_PREFIX

Interval = Tuple[float, float]


def _union(intervals: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _overlap(busy: List[Interval], lo: float, hi: float) -> float:
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in busy)


def _innermost(spans: List[Tuple[float, float, str]], t: float) -> str:
    best, start = "job", float("-inf")
    for a, b, name in spans:
        if a <= t <= b and a >= start:
            best, start = name, a
    return best


def profile(fn: Callable[[], object]) -> Tuple[object, dict]:
    """Run ``fn`` under the profiler; returns its result and the summary:
    ``busy_s``, ``window_s`` (the ``job`` span), ``span_busy`` and
    ``span_wall`` ({span: seconds}), ``device_ops`` and ``idle_gaps``
    (at most 10 ``[name, seconds]`` each, largest first)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        result = fn()
    spans, ops = [], []
    for e in prof.events():
        name = e.name
        lo, hi = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if name.startswith(SPAN_PREFIX):
            if e.device_type == torch.autograd.DeviceType.CPU:
                spans.append((lo, hi, name[len(SPAN_PREFIX):]))
        elif e.device_type == torch.autograd.DeviceType.CUDA and hi > lo:
            ops.append((lo, hi, name))
    jobs = [s for s in spans if s[2] == "job"]
    if not jobs:
        return result, {}
    j0, j1 = jobs[0][0], jobs[0][1]
    inner = [s for s in spans if s[2] != "job" and s[0] >= j0 and s[1] <= j1]
    busy = [(max(a, j0), min(b, j1)) for a, b, _ in ops if b > j0 and a < j1]
    busy = _union(busy)
    per_op: Dict[str, float] = defaultdict(float)
    for a, b, name in ops:
        per_op[name[:160]] += max(0.0, min(b, j1) - max(a, j0))
    gaps: Dict[str, float] = defaultdict(float)
    edge = j0
    for a, b in busy + [(j1, j1)]:
        if a > edge:
            gaps[_innermost(inner, 0.5 * (edge + a))] += a - edge
        edge = max(edge, b)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    span_busy: Dict[str, float] = defaultdict(float)
    span_wall: Dict[str, float] = defaultdict(float)
    for a, b, name in inner:
        span_busy[name] += _overlap(busy, a, b)
        span_wall[name] += b - a
    return result, {
        "busy_s": sum(b - a for a, b in busy),
        "window_s": j1 - j0,
        "span_busy": dict(span_busy),
        "span_wall": dict(span_wall),
        "device_ops": top(per_op),
        "idle_gaps": top(gaps),
    }
