"""The 95th percentile of the per-job wall over every job of the window
(``statistics.quantiles``, exclusive method); nothing under 20 jobs."""

import statistics


def read(run):
    walls = [r.wall for r in run.jobs]
    return statistics.quantiles(walls, n=20)[18] if len(walls) >= 20 else None
