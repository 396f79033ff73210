"""Per-stage wall-clock timers, spans and device profiling.

Port of ``pydca_tpu/profiling.py``: :class:`StageTimers`, :func:`sync` and
:func:`device_trace` (over ``torch.profiler`` in place of
``jax.profiler``).  End a timed region with :func:`sync`: PyTorch returns
before the device has finished, so a host clock without a synchronise
measures the enqueue.

:func:`span` marks a region of the program on the profiler's clock, the
clock the profiler stamps the card's kernels with: a host range named
``pydca/<name>`` while a profiler runs, and a shared null context (one flag
check) otherwise.  Every :meth:`StageTimers.stage` is also a span, so a
trace shows the engines' stages beside the spans inside the fit and the
kernel wrappers.

Usage::

    timers = StageTimers()
    with timers.stage("weights"):       # also the span pydca/weights
        w = sync(stats.sequence_weights(...))
    logger.info("%s", timers.summary())

    with span("plm/linesearch"):        # costs nothing without a profiler
        ...

    with device_trace("dca-trace"):   # no-op when the path is falsy
        fit_plm(...)                  # the trace holds the pydca/* spans
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from . import device as _device

__all__ = ["SPAN_PREFIX", "StageTimers", "device_trace", "span", "synced_stage", "sync"]

SPAN_PREFIX = "pydca/"
_NO_SPAN = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled
# a function-scope RecordFunction: ``torch.profiler.record_function`` opens a
# user-scope one, which the profiler also copies onto the card's timeline as
# an annotation that reads there as device work; this one stays on the host
_range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context over a region of the program: while ``torch.profiler``
    runs, a host ``RecordFunction`` range named ``pydca/<name>``;
    otherwise a shared null context, so that no ``RecordFunction`` is made
    and a span costs one flag check."""
    if _profiling():
        return _range(SPAN_PREFIX + name)
    return _NO_SPAN


def _tensor_leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensor_leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensor_leaves(v)


def sync(x):
    """Wait for the device of every tensor leaf of ``x`` (tensors inside
    lists, tuples and dicts); returns ``x``.  Each card is synchronised
    once; CPU tensors need nothing."""
    for dev in {t.device for t in _tensor_leaves(x)}:
        _device.sync(dev)
    return x


class StageTimers:
    """Ordered wall-clock timers keyed by stage name.

    Re-entering a stage accumulates (so per-chunk optimizer calls sum into
    one row).  ``add_rate`` attaches work counts to stages, and ``summary``
    renders one line per stage with the derived rate.  A stage is also the
    span ``pydca/<name>`` (:func:`span`).
    """

    def __init__(self) -> None:
        self._elapsed: Dict[str, float] = {}
        self._order: List[str] = []
        self._counts: Dict[str, Tuple[float, str]] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            if name not in self._elapsed:
                self._order.append(name)
                self._elapsed[name] = 0.0
            self._elapsed[name] += dt

    def add_rate(self, name: str, count: float, unit: str) -> None:
        """Attach a work count to a stage, e.g. ``add_rate("fit", 100, "iters")``."""
        self._counts[name] = (count, unit)

    def elapsed(self, name: str) -> float:
        return self._elapsed.get(name, 0.0)

    @property
    def total(self) -> float:
        return sum(self._elapsed.values())

    def summary(self) -> str:
        if not self._order:
            return "no stages timed"
        width = max(len(n) for n in self._order)
        lines = []
        for name in self._order:
            dt = self._elapsed[name]
            line = f"{name:<{width}}  {dt:9.3f}s"
            if name in self._counts and dt > 0:
                count, unit = self._counts[name]
                line += f"  ({count / dt:,.1f} {unit}/s)"
            lines.append(line)
        lines.append(f"{'total':<{width}}  {self.total:9.3f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def synced_stage(timers: Optional[StageTimers], name: str, device) -> Iterator[None]:
    """``timers.stage(name)`` ended by a synchronise of ``device``; nothing
    when ``timers`` is ``None``."""
    if timers is None:
        yield
        return
    with timers.stage(name):
        yield
        _device.sync(device)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` context (the CPU, and the card when there is
    one) that writes a Chrome trace, ``trace.<pid>.json``, into ``log_dir``;
    a no-op when ``log_dir`` is falsy.  The trace holds the program's
    ``pydca/*`` spans (:func:`span`) beside the operations and kernels.  A
    profiler that fails to start raises."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace.{os.getpid()}.json"))
