"""The L-BFGS iterations of every family of a benchmark cell's pool, on one GPU.

    env PYTHONPATH=<checkout> python scripts/torch_pool_iterations.py [cell]

Runs one job (``dcabench.jobs.run_job``, as the benchmark's window runs it)
on each family of the pool of ``cell`` (default ``pf02826_16k.plm``) of
the checkout on ``PYTHONPATH``, in the order seed 0 gives, after a
warm-up job, and
prints a line a family (its iterations, evaluations, host reads, the first
trials the fused loop queued ahead and threw away, where the checkout
counts them, and wall seconds) and one JSON line with the lists and the
mean iterations.  The
program and the pool are the checkout's: point ``PYTHONPATH`` at two
checkouts to compare their fits family by family on the same card.  Prints
the card's name and power limit first.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# one host thread for every pool, as dcabench/run.py sets it before torch loads
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"


def main(argv) -> int:
    cell_name = argv[1] if len(argv) > 1 else "pf02826_16k.plm"
    import torch

    if not torch.cuda.is_available():
        print("torch_pool_iterations: no CUDA card", file=sys.stderr)
        return 1
    from dcabench import harness
    from dcabench.jobs import run_job
    from dcabench.spec import ROOT, load_cell
    from pydca_tpu_torch import plm
    from pydca_tpu_torch.runtime import enable_compilation_cache

    fits = []  # each fit's result, for the counter the job record leaves out
    fit_plm = plm.fit_plm
    plm.fit_plm = lambda *a, **kw: fits.append(fit_plm(*a, **kw)) or fits[-1]

    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip(), flush=True)
    harness.set_caches(ROOT)
    enable_compilation_cache(os.environ["PYDCA_TPU_CACHE_DIR"])
    torch.set_num_threads(1)
    cell = load_cell(cell_name, ROOT)
    count = harness.pool_size(cell)
    pool = harness.make_pool(cell, 0)  # the seed orders the pool: seed 0 on both sides
    dev = torch.device("cuda")
    opts = harness.engine_options(cell)
    kind, bio = cell.traffic["engine"], cell.config["biomolecule"]
    run_job(kind, 0, 0, pool[0], bio, dev, opts)  # warm-up
    rows = []
    for f in range(count):
        rec, _ = run_job(kind, f, f, pool[f], bio, dev, opts)
        discarded = getattr(fits[-1], "discarded_trials", None)
        rows.append(dict(position=f, **rec.fit, discarded_trials=discarded, wall=rec.wall))
        print(f"family at position {f}: {rec.fit['num_iters']} iterations, "
              f"{rec.fit['n_evals']} evaluations, {rec.fit['host_syncs']} reads, "
              f"{discarded} discarded trials, {rec.wall:.4f} s", flush=True)
    iters = [r["num_iters"] for r in rows]
    print(json.dumps({"root": str(ROOT), "device": torch.cuda.get_device_name(0),
                      "cell": cell_name, "iters": iters, "mean_iters": sum(iters) / len(iters),
                      "reads": [r["host_syncs"] for r in rows],
                      "discarded": [r["discarded_trials"] for r in rows],
                      "walls": [r["wall"] for r in rows]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
