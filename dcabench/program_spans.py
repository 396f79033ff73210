"""The program's own spans in a profile, reduced to one row a span name.

The program opens ``torch.profiler.record_function`` ranges named
``pydca/<name>`` at its layer boundaries (``pydca_tpu_torch.profiling.span``:
the engines' stages, the parts of the fused L-BFGS step, each host read, the
logits products, the kernel wrappers).  They are on the clock the profiler
stamps the card's operations with, so each device operation can be given to
the spans open on the host when it was launched, and each stretch in which
the card ran nothing to the spans open on the host at that moment.

:func:`table` is a pure function over plain records, so that it can be
tested without a card; :func:`records` takes them from a finished
``torch.profiler.profile``, and :func:`profile` runs a callable under one.
A program without such spans gives an empty table.  The spans are assumed
to nest, as the ranges of one host thread do.

``trace.profile`` does not read them; one job of a cell is traced for them
by::

    python3 -m dcabench.program_spans --workload <cell> --seed <n>

which runs a warm-up job, then one job as it runs untraced and once more
under the profiler, as the benchmark's traced run does, and prints the idle seconds by program span on
standard error and, on standard output, one JSON object: the table, the
readings of :data:`READERS` (``dcabench/metrics/<name>.py``), the traced
fit's counts and the job's wall, traced and not.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
from collections import defaultdict
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

PREFIX = "pydca/"
# ranges the profiler also copies onto the device's timeline, which are no
# work: the benchmark's own ``record_function`` ranges (``jobs.SPAN_PREFIX``)
_ANNOTATIONS = "dcabench/"
# the metrics that read the table, each ``read(run)`` with ``run.profile``
# holding it under ``program``
READERS = ("lbfgs_host_ms_per_iter", "fit_nonproduct_ms_per_iter", "fit_kernels_per_iter",
           "identity_counts_kernel_roofline")

Span = Tuple[float, float, str]  # host start, host end (s), name
Op = Tuple[Optional[float], float, float]  # host launch (None: unknown), device start, end (s)


def _nesting(spans: Sequence[Span]):
    """The spans' parents (index or -1) and the elementary stretches of the
    host timeline, ``[(start, innermost span index or -1)]`` in time order."""
    points = []
    for i, (a, b, _) in enumerate(spans):
        # at one time, ends before starts; of two ends the inner one (the
        # later start) first, of two starts the outer one (the later end)
        points.append((a, 1, -b, i))
        points.append((b, 0, -a, i))
    points.sort()
    parent = [-1] * len(spans)
    stack: List[int] = []
    marks: List[Tuple[float, int]] = []
    for t, opens, _, i in points:
        if opens:
            parent[i] = stack[-1] if stack else -1
            stack.append(i)
        elif stack and stack[-1] == i:
            stack.pop()
        elif i in stack:  # a span that did not nest
            stack.remove(i)
        inner = stack[-1] if stack else -1
        if marks and marks[-1][0] == t:
            marks[-1] = (t, inner)
        else:
            marks.append((t, inner))
    return parent, marks


def _busy_before(ops: Sequence[Op]):
    """The union of the device intervals and a function ``t -> busy seconds
    before t``."""
    union: List[List[float]] = []
    for _, a, b in sorted(ops, key=lambda o: o[1]):
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    starts = [a for a, _ in union]
    before = [0.0]
    for a, b in union:
        before.append(before[-1] + b - a)

    def busy(t: float) -> float:
        k = bisect.bisect_right(starts, t)
        if k == 0:
            return 0.0
        a, b = union[k - 1]
        return before[k - 1] + min(t, b) - a

    return busy


def table(spans: Sequence[Span], ops: Sequence[Op]) -> Dict[str, dict]:
    """One row a span name: ``calls``, ``wall_s`` (the host time of its
    calls), ``device_s`` and ``kernels`` (the device operations launched
    while it was open, its nested spans' included; an operation launched
    under no span counts toward none), ``idle_s`` (the seconds inside its
    calls in which the device ran nothing) and ``idle_self_s`` (the part of
    those seconds in which it was the innermost span open)."""
    parent, marks = _nesting(spans)
    chains: Dict[int, Tuple[str, ...]] = {}

    def chain(i: int) -> Tuple[str, ...]:
        """The names of span ``i`` and its ancestors, each once."""
        if i not in chains:
            names = [spans[i][2]]
            if parent[i] >= 0:
                names += [n for n in chain(parent[i]) if n != spans[i][2]]
            chains[i] = tuple(names)
        return chains[i]

    rows: Dict[str, dict] = defaultdict(lambda: {"calls": 0, "wall_s": 0.0, "device_s": 0.0,
                                                 "kernels": 0, "idle_s": 0.0,
                                                 "idle_self_s": 0.0})
    for a, b, name in spans:
        rows[name]["calls"] += 1
        rows[name]["wall_s"] += b - a
    times = [t for t, _ in marks]
    for launch, a, b in ops:
        k = bisect.bisect_right(times, launch) - 1 if launch is not None else -1
        if k < 0 or marks[k][1] < 0:
            continue
        for name in chain(marks[k][1]):
            rows[name]["device_s"] += b - a
            rows[name]["kernels"] += 1
    busy = _busy_before(ops)
    for (t0, inner), (t1, _) in zip(marks, marks[1:]):
        if inner < 0:
            continue
        idle = (t1 - t0) - (busy(t1) - busy(t0))
        rows[spans[inner][2]]["idle_self_s"] += idle
        for name in chain(inner):
            rows[name]["idle_s"] += idle
    return dict(rows)


def records(prof) -> Tuple[List[Span], List[Op]]:
    """The program's spans and the device operations of a finished
    ``torch.profiler.profile``, in seconds on the profiler's clock.  An
    operation's launch is the host call that launched it: the CUDA API call
    (``cuda*`` or ``cu*``) the profiler gives the same correlation id
    (unknown where it recorded none)."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    spans, device, launch_of = [], [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns() * 1e-9
        b = a + e.duration_ns() * 1e-9
        if e.device_type() != cpu:
            if b > a and not name.startswith(_ANNOTATIONS):
                device.append((e.correlation_id(), a, b))
        elif name.startswith("cu"):
            launch_of[e.correlation_id()] = a
        elif name.startswith(PREFIX):
            spans.append((a, b, name))
    return spans, [(launch_of.get(corr), a, b) for corr, a, b in device]


def idle_line(rows: Dict[str, dict], top: int = 10) -> str:
    """The device's idle seconds by the innermost program span open, the
    largest ``top``."""
    idle = sorted(((r["idle_self_s"], n) for n, r in rows.items() if r["idle_self_s"] > 0),
                  reverse=True)[:top]
    return "dcabench: idle by program span: " + (
        ", ".join(f"{n} {s:.6f} s" for s, n in idle) if idle else "none")


def profile(fn: Callable[[], object]) -> Tuple[object, Dict[str, dict]]:
    """Run ``fn`` under the profiler (the CPU, and the card when there is
    one); returns its result and :func:`table` of the program's spans."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        result = fn()
    return result, table(*records(prof))


def main(argv=None, root=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m dcabench.program_spans",
                                description="Trace one job of a cell for the program's spans.")
    p.add_argument("--workload", required=True, help="a one-card cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"  # as dcabench.run sets them

    from .harness import engine_options, make_pool, set_caches
    from .spec import ROOT, load_cell, reader

    root = ROOT if root is None else root
    set_caches(root)
    import torch

    from pydca_tpu_torch.runtime import enable_compilation_cache

    from .jobs import run_job

    torch.set_num_threads(1)
    enable_compilation_cache(os.environ["PYDCA_TPU_CACHE_DIR"])
    cell = load_cell(args.workload, root)
    dev = torch.device(args.device)
    kind, opts, pool = cell.traffic["engine"], engine_options(cell), make_pool(cell, args.seed)

    def job(k):
        fam = k % len(pool)
        return run_job(kind, k, fam, pool[fam], cell.config["biomolecule"], dev, opts)

    job(0)  # warm-up
    plain, _ = job(1)  # the traced job's family, untraced: what tracing costs
    (rec, _), rows = profile(lambda: job(1))
    print(idle_line(rows), file=sys.stderr, flush=True)
    c = cell.config
    run = SimpleNamespace(kind=kind, profile={"program": rows}, profiled=rec,
                          n=c["num_seqs"], l=c["seqs_len"], q=c["q"])
    print(json.dumps({"workload": cell.name, "seed": args.seed, "fit": rec.fit,
                      "wall_s": rec.wall, "untraced_wall_s": plain.wall,
                      "readings": {name: reader(name, root)(run) for name in READERS},
                      "program": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
