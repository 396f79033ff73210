"""Per-stage wall-clock timers.

Port of ``pydca_tpu/profiling.py``'s :class:`StageTimers`.  End a timed
region with :func:`sync` (``torch.cuda.synchronize`` on a card): PyTorch
returns before the device has finished, so a host clock without a
synchronise measures the enqueue.

Usage::

    timers = StageTimers()
    with timers.stage("weights"):
        w = stats.sequence_weights(...)
        sync(w.device)
    logger.info("%s", timers.summary())
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Tuple

from .device import sync

__all__ = ["StageTimers", "sync"]


class StageTimers:
    """Ordered wall-clock timers keyed by stage name.

    Re-entering a stage accumulates (so per-chunk optimizer calls sum into
    one row).  ``add_rate`` attaches work counts to stages, and ``summary``
    renders one line per stage with the derived rate.
    """

    def __init__(self) -> None:
        self._elapsed: Dict[str, float] = {}
        self._order: List[str] = []
        self._counts: Dict[str, Tuple[float, str]] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
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
