"""The readings that the limits of ``dcabench/limits/<cell>.json`` are set
from, in one process on one card:

- the program: one job of the cell's traffic on each seed's first family
  (the family a run's first job takes), judged as a run judges it;
- the control: the reference put in the program's place at the nearest
  precision below float32 with TF32 off, TF32: its products' operands
  and the score stage's input couplings rounded to TF32's 10-bit mantissa,
  on the same families;
- the program's own lower-precision path where it has one (plmDCA's
  ``precision="bfloat16"``), for comparison;
- plmDCA: the program with a fault planted in its fit (:data:`FIT_FAULTS`:
  a fit cut at 10 or 50 iterations, a fit that returns its start and
  counts no iteration), the readings that the stop numbers' limits lie
  below.

    python3 -m dcabench.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--bf16-seeds 1,2,3] [--fault-seeds 1,2,3] \
        [--out path.json]

A cell on several chips reads only its control here (one card; the
reference is plain): its program readings are its runs' own.  Prints one
JSON line a reading and, with ``--out``, writes them all.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys
import time

import numpy as np


def cut_fit(fit, iterations: int = 10):
    """The fit stopped after ``iterations`` iterations, as a smaller budget
    or a looser stop test would stop it."""
    @functools.wraps(fit)
    def wrapped(*args, **kwargs):
        return fit(*args, **{**kwargs, "max_iterations": min(iterations,
                                                              kwargs.get("max_iterations", 100))})
    return wrapped


def start_fit(fit):
    """A fit that returns pydca's start and counts no iteration."""
    @functools.wraps(fit)
    def wrapped(msa, weights, lambda_h, lambda_j, l, q, **kwargs):
        from pydca_tpu_torch.plm import init_params

        res = fit(msa, weights, lambda_h, lambda_j, l, q, **{**kwargs, "max_iterations": 0})
        return res._replace(x=init_params(msa, weights, l, q), num_iters=0)
    return wrapped


FIT_FAULTS = {"cut10": cut_fit, "cut50": functools.partial(cut_fit, iterations=50),
              "start": start_fit}


@contextlib.contextmanager
def planted(fault):
    """``pydca_tpu_torch.plm.fit_plm`` with ``fault`` planted, for the block."""
    import pydca_tpu_torch.plm as prog_plm

    orig = prog_plm.fit_plm
    prog_plm.fit_plm = fault(orig)
    try:
        yield
    finally:
        prog_plm.fit_plm = orig


def _ranked(scores, l: int):
    iu, ju = np.triu_indices(l, k=1)
    s = scores.detach().cpu().numpy()
    order = np.argsort(-s, kind="stable")
    return [((int(iu[k]), int(ju[k])), float(s[k])) for k in order]


def control_output(cell, codes_np, device):
    """The reference as the program would run it, in TF32: ``JobOutput``."""
    import torch

    from .jobs import JobOutput
    from .reference import meanfield as ref_mf
    from .reference import tf32
    from .reference import plm as ref_plm
    from .reference.weights import sequence_weights

    c, opts = cell.config, cell.traffic.get("options", {})
    l, q = c["seqs_len"], c["q"]
    codes = torch.from_numpy(np.ascontiguousarray(codes_np)).to(device)
    w = sequence_weights(codes, float(opts.get("seqid", 0.8)), q)
    if cell.traffic["engine"] == "plm":
        lam = 0.2 * (l - 1)
        fit = ref_plm.fit(codes, w, lam, lam, l, q, dtype=torch.float32, tf32_products=True,
                          max_iterations=int(opts.get("max_iterations", 100)))
        blocks = fit.theta[l * q:].reshape(-1, q, q)[:, : q - 1, : q - 1]
        scores = ref_plm.apc(ref_plm.gauge_fn(tf32(blocks)), l)
        return JobOutput(0, 0, w, fit.theta.cpu().numpy(), _ranked(scores, l),
                         iters=fit.num_iters)
    j = ref_mf.couplings(codes, w, q, float(opts.get("pseudocount", 0.5)),
                         dtype=torch.float32, tf32_products=True)
    qm1 = q - 1
    iu, ju = torch.triu_indices(l, l, offset=1, device=j.device)
    scores = ref_plm.apc(ref_plm.gauge_fn(tf32(j.reshape(l, qm1, l, qm1)[iu, :, ju, :])), l)
    return JobOutput(0, 0, w, j, _ranked(scores, l))


def look(cell, pool, o, device) -> dict:
    """plmDCA: the judge's readings beside the compared ones."""
    if cell.traffic["engine"] != "plm":
        return {}
    from .reference import judge

    c, l = cell.config, cell.config["seqs_len"]
    lam = 0.2 * (l - 1)
    jd = judge.PlmJudge(l, c["q"], 0.8, lam, lam, device)
    return jd.look(0, pool[0], o.params, o.iters, o.ranked)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m dcabench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--bf16-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from .harness import ROOT, engine_options, judge_outputs, planted_families, set_caches
    from .spec import load_cell

    set_caches(ROOT)
    import os

    import torch

    from .jobs import run_job
    from pydca_tpu_torch.runtime import enable_compilation_cache

    enable_compilation_cache(os.environ["PYDCA_TPU_CACHE_DIR"])
    cell = load_cell(args.workload)
    dev = torch.device(args.device)
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    kind, bio = cell.traffic["engine"], cell.config["biomolecule"]
    out = []

    def emit(role, seed, numbers, extra=None):
        rec = {"cell": cell.name, "role": role, "seed": seed, **numbers, **(extra or {})}
        out.append(rec)
        print(json.dumps(rec), flush=True)

    def family(seed):  # a seed's own family, not the pool's
        return planted_families(cell, seed % (1 << 64), 1)

    def program(seed, opts):
        pool = family(seed)
        rec, o = run_job(kind, 0, 0, pool[0], bio, dev, opts)
        return pool, rec, o

    one_card = cell.chips == 1
    if one_card and seeds(args.seeds):
        program(seeds(args.seeds)[0], engine_options(cell))  # warm-up
    runs = [("program", seeds(args.seeds), engine_options(cell), None),
            ("program_bf16", seeds(args.bf16_seeds),
             {**engine_options(cell), "precision": "bfloat16"}, None)]
    if kind == "plm":
        runs += [(f"fault_{name}", seeds(args.fault_seeds), engine_options(cell), fault)
                 for name, fault in FIT_FAULTS.items()]
    for role, seed_list, opts, fault in runs:
        for seed in seed_list if one_card else []:
            with planted(fault) if fault else contextlib.nullcontext():
                pool, rec, o = program(seed, opts)
            emit(role, seed, judge_outputs(cell, pool, [o], dev),
                 {"wall": rec.wall, **(rec.fit or {}), **look(cell, pool, o, dev)})
            del o
    for seed in seeds(args.control_seeds):
        pool = family(seed)
        t0 = time.perf_counter()
        o = control_output(cell, pool[0], dev)
        emit("control_tf32", seed, judge_outputs(cell, pool, [o], dev),
             {"wall": time.perf_counter() - t0, "num_iters": o.iters, **look(cell, pool, o, dev)})
        del o
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
