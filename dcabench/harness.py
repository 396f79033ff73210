"""The benchmark's run of one cell: set-up, the measured window, the traced
job, the comparison with the reference, and the result line.

A cell on K > 1 chips runs as K rank processes (one a card, NCCL; gloo on
the CPU in tests) that meet at ``tcp://localhost:<port>``; every rank runs
the same jobs on its data-parallel share, rank 0 decides when the window
closes, judges the outputs and prints the line.

Traffic (``dcabench/traffic/<mix>.json``), read by one generator:

- ``engine``: ``plm`` or ``mf``; ``options``: the engine's keyword
  arguments (the CLI's defaults, stated);
- ``pool``: how many planted families the pool holds (:func:`pool_size`;
  :mod:`.planted` with ``family``'s parameters at the configuration's N,
  L, q).  They are the same families in every run, drawn from
  :data:`POOL_SEED` and kept in ``dcabench/_cache/pools/`` after the
  first run of a checkout; ``--seed`` orders them.  Job k takes family
  ``k mod pool``, on fresh host arrays, with a new engine: one client,
  closed loop, jobs back to back until ``--seconds`` have passed and the
  job in flight has ended;
- ``check``: how many of the window's jobs the reference judges, drawn
  from the seed (a reservoir sample over the jobs as they end).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import queue as queue_mod
import socket
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace
from typing import List, Optional

import numpy as np

from .spec import ROOT, Cell, load_cell, reader

FORBIDDEN = ("jax", "jaxlib", "flax", "pydca_tpu")
CACHE = Path("dcabench") / "_cache"  # inside the checkout, git-ignored
POOL_SEED = 16  # every run fits the same families: a family's fit takes its own iterations


def process_start() -> float:
    """The epoch seconds at which this process started (``/proc``), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def set_caches(root: Path) -> None:
    """Fixed build and kernel cache directories inside the checkout."""
    os.environ["PYDCA_TPU_CACHE_DIR"] = str(root / CACHE / "pydca")
    os.environ["TRITON_CACHE_DIR"] = str(root / CACHE / "triton")



def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def planted_families(cell: Cell, base: int, count: int) -> List[np.ndarray]:
    """``count`` planted families of the cell's shape, drawn from ``base``."""
    from .planted import planted_family

    c = cell.config
    return [planted_family(c["num_seqs"], c["seqs_len"], c["q"],
                           seed=np.random.SeedSequence([base, f]), **cell.traffic["family"])[0]
            for f in range(count)]


def _pool_path(cell: Cell, count: int) -> Path:
    """The pool's file in the checkout's cache, named by everything that
    decides its families: the shape, the family parameters, the count, the
    seed and the generator's source."""
    from . import planted

    c = cell.config
    key = json.dumps([c["num_seqs"], c["seqs_len"], c["q"], cell.traffic["family"], count,
                      POOL_SEED, Path(planted.__file__).read_text()], sort_keys=True)
    return cell.root / CACHE / "pools" / f"{hashlib.sha256(key.encode()).hexdigest()[:24]}.npy"


def make_pool(cell: Cell, seed: int) -> List[np.ndarray]:
    """The pool's families, in the order the jobs take them: the same
    families in every run (:data:`POOL_SEED`), ordered by ``--seed``.  The
    first run of a checkout draws them and keeps them in the cache."""
    count = pool_size(cell)
    path = _pool_path(cell, count)
    try:
        fams = np.load(path)
    except (OSError, ValueError):
        fams = np.stack(planted_families(cell, POOL_SEED, count))
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npy")
        np.save(tmp, fams)
        os.replace(tmp, path)
    order = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), 1 << 21]))
    return [fams[i] for i in order.permutation(count)]


def pool_size(cell: Cell) -> int:
    """Families in the pool: ``pool.cells`` one-hot cells (N·L·q each
    family) at most, clamped to ``[pool.min, pool.max]``: many families of
    a small alignment, few of a deep one, at about the same set-up cost."""
    c, p = cell.config, cell.traffic["pool"]
    per = c["num_seqs"] * c["seqs_len"] * c["q"]
    return int(min(max(p["cells"] // per, p["min"]), p["max"]))


def engine_options(cell: Cell) -> dict:
    import torch

    opts = dict(cell.traffic.get("options", {}))
    if cell.traffic["engine"] == "plm":
        opts["precision"] = cell.config["precision"]
    else:
        opts["dtype"] = getattr(torch, cell.config["precision"])
    return opts


def judge_outputs(cell: Cell, pool, outs, device) -> dict:
    """The worst reading of each compared number over the judged jobs."""
    from .reference import judge

    c, kind = cell.config, cell.traffic["engine"]
    l, q = c["seqs_len"], c["q"]
    opts = cell.traffic.get("options", {})
    seqid = float(opts.get("seqid", 0.8))
    if kind == "plm":
        lam = 0.2 * (l - 1)
        jd = judge.PlmJudge(l, q, seqid, float(opts.get("lambda_h", lam)),
                            float(opts.get("lambda_J", lam)), device,
                            max_iterations=int(opts["max_iterations"]))
        readings = [jd.numbers(o.family, pool[o.family], o.weights, o.params, o.iters,
                               o.ranked) for o in outs]
    else:
        jd = judge.MeanFieldJudge(l, q, seqid, float(opts.get("pseudocount", 0.5)), device)
        readings = [jd.numbers(o.family, pool[o.family], o.weights, o.params, o.ranked)
                    for o in outs]
    return judge.worst(readings)


def _finite(v: float) -> float:
    return v if math.isfinite(v) else 1e300


def run_rank(rank: int, world: int, cell_name: str, seed: int, seconds: float, trace: bool,
             device: str, root: Path, t_start: float, port: Optional[int] = None,
             patch: Optional[str] = None) -> int:
    """One rank of a run; rank 0 prints the result line.  Returns the exit code."""
    set_caches(root)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    cell = load_cell(cell_name, root)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < world:
            print(f"dcabench: {cell_name} needs {world} card(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    if world > 1:
        from datetime import timedelta

        kw = {"device_id": dev} if dev.type == "cuda" else {}
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=600), **kw)
    if patch:
        mod, fn = patch.split(":")
        getattr(__import__(mod, fromlist=[fn]), fn)()
    try:
        return _measure(rank, world, cell, seed, seconds, trace, dev, t_start)
    finally:
        if world > 1:
            dist.destroy_process_group()


def _measure(rank, world, cell: Cell, seed, seconds, trace, dev, t_start) -> int:
    import torch
    import torch.distributed as dist

    from .jobs import run_job
    from .trace import profile
    from pydca_tpu_torch.runtime import enable_compilation_cache

    enable_compilation_cache(os.environ["PYDCA_TPU_CACHE_DIR"])
    on_card = dev.type == "cuda"
    kind, bio = cell.traffic["engine"], cell.config["biomolecule"]
    opts = engine_options(cell)
    pool = make_pool(cell, seed)

    def job(k, timed=False):
        fam = k % len(pool)
        return run_job(kind, k, fam, pool[fam], bio, dev, opts, world, timed)

    def agree(flag: bool) -> bool:
        if world == 1:
            return flag
        t = torch.tensor([1.0 if flag else 0.0], device=dev)
        dist.broadcast(t, 0)
        return bool(t.item())

    job(0)  # warm-up: every shape the window's jobs use
    if world > 1:
        dist.barrier()
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    records, sample = [], []
    check_rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), 1 << 20]))
    n_check, proc_peak, k = int(cell.traffic["check"]), 0, 0
    while True:
        rec, out = job(k)
        records.append(rec)
        if on_card:
            proc_peak = max(proc_peak, torch.cuda.max_memory_allocated(dev))
        if len(sample) < n_check:
            sample.append(out)
        else:
            j = int(check_rng.integers(0, k + 1))
            if j < n_check:
                sample[j] = out
        del out
        k += 1
        if agree(time.perf_counter() - t0 >= seconds):
            break
    window_s = time.perf_counter() - t0
    peak = max(r.peak_bytes for r in records)
    if rank == 0:
        walls = sorted(r.wall for r in records)
        print(f"dcabench: {cell.name} seed {seed}: {len(records)} jobs in {window_s:.3f} s, "
              f"job wall min {walls[0]:.4f} median {walls[len(walls) // 2]:.4f} "
              f"max {walls[-1]:.4f} s; set-up {setup_s:.3f} s", file=sys.stderr, flush=True)
    prof_sum, prof_rec, timed_rec = None, None, None
    if trace:
        (prof_rec, _), prof_sum = profile(lambda: job(k))
        if world > 1:
            timed_rec, _ = job(k + 1, timed=True)
    busy = prof_sum.get("busy_s", 0.0) if prof_sum else 0.0
    if world > 1:
        t = torch.tensor([float(peak), float(proc_peak), busy], dtype=torch.float64, device=dev)
        mx = t.clone()
        dist.all_reduce(mx, op=dist.ReduceOp.MAX)
        dist.all_reduce(t)
        peak, proc_peak, busy = int(mx[0]), int(mx[1]), float(t[2]) / world
    checks = {}
    if rank == 0:
        if on_card:
            torch.cuda.empty_cache()
        numbers = judge_outputs(cell, pool, sample, dev)
        checks = {n: {"value": _finite(v), "limit": cell.limits[n]} for n, v in numbers.items()}
    del sample
    if world > 1:
        dist.barrier()
    if rank != 0:
        return 0
    run = SimpleNamespace(
        cell=cell, kind=kind, chips=world, seed=seed, setup_s=setup_s, window_s=window_s,
        jobs=records, peak_bytes=peak, busy_s=busy, profile=prof_sum, profiled=prof_rec,
        timed=timed_rec,
        n=cell.config["num_seqs"], l=cell.config["seqs_len"], q=cell.config["q"],
        precision=cell.config["precision"],
    )
    metrics = {}
    for m in cell.metrics(trace):
        v = reader(m["name"], cell.root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
              "count": world, "memory_peak_bytes": int(proc_peak)}
    if trace:
        device["busy_s"] = busy
        device["window_s"] = prof_sum.get("window_s", 0.0) if prof_sum else 0.0
    result = {"correct": correct, "attempted": len(records), "failed": 0, "metrics": metrics,
              "device": device}
    if trace and prof_sum:
        result["breakdown"] = {"device_ops": prof_sum["device_ops"],
                               "idle_gaps": prof_sum["idle_gaps"]}
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        print(f"dcabench: the process holds {found} once the window has closed", file=sys.stderr)
        return 3
    for name, c in checks.items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def _rank_entry(rank, world, args, queue):
    try:
        code = run_rank(rank, world, *args)
    except Exception:  # report the rank's failure to the parent, which stops the others
        traceback.print_exc()
        code = 1
    queue.put((rank, code))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             root: Path = ROOT, patch: Optional[str] = None,
             t_start: Optional[float] = None) -> int:
    """Run one cell; prints the result line; returns the exit code.  Cells on
    more than one chip run as that many rank processes, spawned here."""
    import multiprocessing as mp

    t_start = process_start() if t_start is None else t_start
    world = load_cell(cell_name, root).chips
    if world == 1:
        return run_rank(0, 1, cell_name, seed, seconds, trace, device, root, t_start, None, patch)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    args = (cell_name, seed, seconds, trace, device, root, t_start, free_port(), patch)
    procs = [ctx.Process(target=_rank_entry, args=(r, world, args, queue)) for r in range(world)]
    for p in procs:
        p.start()
    code, codes = 0, {}
    try:
        while len(codes) < world and not code:
            try:
                rank, c = queue.get(timeout=1.0)
                codes[rank] = c
            except queue_mod.Empty:  # a rank that died without reporting
                for rank, p in enumerate(procs):
                    if rank not in codes and p.exitcode:
                        codes[rank] = p.exitcode
            code = next((c for c in codes.values() if c), 0)
        if code:
            for p in procs:  # the others would wait for it in a collective
                p.terminate()
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    return code
