"""The program's spans on every rank of a benchmark cell on several cards.

    env PYTHONPATH=. python scripts/torch_mesh_spans.py \
        [--workload pf02826_100k.plm_mesh4] --seed <n> [--device cuda|cpu]

Starts the cell's ranks as the benchmark's harness does (one process a
card, NCCL over ``tcp://localhost``; gloo on the CPU), and on each rank runs
a warm-up job, then one job untraced and the same job under
``torch.profiler`` (``dcabench.jobs.run_job`` on the cell's pool, with a
data mesh over the ranks).  For each rank, in rank order, it prints the
idle seconds by program span (``dcabench.program_spans.idle_line``) on
standard error and one JSON line on standard output: the rank, the fit's
counts, the job's wall traced and not, the collectives ``DataMesh``
counted (``[calls, elements, seconds, bytes]`` a name), the NCCL kernels'
device seconds, in all and launched under a ``pydca/mesh/*`` span, and the
span table (``dcabench.program_spans.table`` over
``program_spans.records``).  Prints the cards' name and power limit first.

``--root`` runs another checkout's cell; ``--patch module:fn`` calls ``fn``
in each rank once its group is up, as the harness's hook does.  Exits 1
when a rank fails, after stopping the others.
"""

from __future__ import annotations

import argparse
import json
import os
import queue as queue_mod
import subprocess
import sys
import traceback
from datetime import timedelta
from pathlib import Path

# one host thread for every pool, as dcabench/run.py sets it before torch loads
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

MESH_PREFIX = "pydca/mesh/"


def nccl_kernels(prof, spans) -> dict:
    """Device seconds and count of the NCCL kernels of a profile, in all
    and launched while a ``pydca/mesh/*`` span was open."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    mesh = [(a, b) for a, b, name in spans if name.startswith(MESH_PREFIX)]
    launch_of, kernels = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cpu:
            if e.name().startswith("cu"):
                launch_of[e.correlation_id()] = e.start_ns() * 1e-9
        elif e.name().startswith("nccl") and not e.is_user_annotation():
            kernels.append((e.correlation_id(), e.duration_ns() * 1e-9))
    out = {"device_s": 0.0, "count": 0, "under_mesh_device_s": 0.0, "under_mesh_count": 0}
    for corr, seconds in kernels:
        out["device_s"] += seconds
        out["count"] += 1
        t = launch_of.get(corr)
        if t is not None and any(a <= t <= b for a, b in mesh):
            out["under_mesh_device_s"] += seconds
            out["under_mesh_count"] += 1
    return out


def trace_rank(rank: int, world: int, args, port: int) -> dict:
    """One rank: the group, a warm-up job, the job untraced and traced."""
    from dcabench import program_spans
    from dcabench.harness import engine_options, make_pool, set_caches
    from dcabench.jobs import run_job
    from dcabench.spec import load_cell

    root = Path(args.root)
    set_caches(root)
    import torch
    import torch.distributed as dist

    from pydca_tpu_torch.runtime import enable_compilation_cache

    torch.set_num_threads(1)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
                            timeout=timedelta(seconds=600), **kw)
    try:
        if args.patch:
            mod, fn = args.patch.split(":")
            getattr(__import__(mod, fromlist=[fn]), fn)()
        enable_compilation_cache(os.environ["PYDCA_TPU_CACHE_DIR"])
        cell = load_cell(args.workload, root)
        kind, bio = cell.traffic["engine"], cell.config["biomolecule"]
        opts, pool = engine_options(cell), make_pool(cell, args.seed)

        def job(k):
            fam = k % len(pool)
            return run_job(kind, k, fam, pool[fam], bio, dev, opts, world)

        job(0)  # warm-up
        plain, _ = job(1)  # the traced job's family, untraced: what tracing costs
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            rec, _ = job(1)
        spans, ops = program_spans.records(prof)
        rows = program_spans.table(spans, ops)
        return {"rank": rank, "workload": cell.name, "seed": args.seed, "fit": rec.fit,
                "wall_s": rec.wall, "untraced_wall_s": plain.wall,
                "collectives": rec.collectives, "nccl_kernels": nccl_kernels(prof, spans),
                "idle_line": program_spans.idle_line(rows), "program": rows}
    finally:
        dist.destroy_process_group()


def _rank_entry(rank, world, args, port, queue):
    try:
        queue.put((rank, trace_rank(rank, world, args, port)))
    except Exception:  # report the failure to the parent, which stops the others
        traceback.print_exc()
        queue.put((rank, None))


def main(argv=None) -> int:
    import multiprocessing as mp

    from dcabench.harness import free_port
    from dcabench.spec import ROOT, load_cell

    p = argparse.ArgumentParser(prog="torch_mesh_spans.py", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="pf02826_100k.plm_mesh4",
                   help="a cell of BENCHMARK.json on several cards")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", default="cuda", help="cuda (one rank a card) or cpu (gloo)")
    p.add_argument("--root", default=str(ROOT), help="the checkout whose cell runs")
    p.add_argument("--patch", default=None, help="module:fn called in each rank")
    args = p.parse_args(argv)
    world = load_cell(args.workload, Path(args.root)).chips
    if args.device == "cuda":
        smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
        print(subprocess.run(smi, capture_output=True, text=True).stdout.strip(), flush=True)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_entry, args=(r, world, args, port, queue))
             for r in range(world)]
    for proc in procs:
        proc.start()
    results, failed = {}, False
    try:
        while len(results) < world and not failed:
            try:
                rank, res = queue.get(timeout=1.0)
                results[rank] = res
                failed = res is None
            except queue_mod.Empty:  # a rank that died without reporting
                failed = any(proc.exitcode for proc in procs)
        if failed:
            for proc in procs:  # the others would wait for it in a collective
                proc.terminate()
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
                proc.join()
    if failed:
        print("torch_mesh_spans: a rank failed", file=sys.stderr)
        return 1
    for rank in range(world):
        res = results[rank]
        print(f"rank {rank}: {res.pop('idle_line')}", file=sys.stderr, flush=True)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
