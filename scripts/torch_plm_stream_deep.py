"""The deep plmDCA streaming fit on one GPU: N = 10^5, L = 1000, q = 21.

    env PYTHONPATH=. python scripts/torch_plm_stream_deep.py

Draws the planted protein family of ``chip_smoke.py``'s phase 12 on the
host (seed 12, 20 planted pairs; D = 220300500 parameters), then runs the
engine as a user would, ``PlmDCA(..., device="cuda")`` and
``compute_sorted_FN_APC()`` with the full 100-iteration budget: past 1 GiB
of logits the engine streams by itself, 8 blocks of 12782 sequences.
Prints the card's name and power limit, one line with the draw time, the
weights time, the fit wall, iterations, evaluations, s per iteration and
per evaluation, host syncs per iteration, the score time, peak device
memory and the planted recovery, and one JSON line.  The engine's
progress (every 50 iterations) goes to stderr.  Exits 1 without a card,
off the streaming route, or on a non-finite score.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from chip_smoke import DEEP_SHAPE, fit_text
from pydca_tpu_torch import alphabets
from pydca_tpu_torch.config_log import configure_logging
from pydca_tpu_torch.io.fasta import MSA
from pydca_tpu_torch.ops import cuda_kernels as ck
from pydca_tpu_torch.plm import PlmDCA
from pydca_tpu_torch.synthetic import PLANTED_TOP, planted_family, planted_recovery


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_plm_stream_deep: no CUDA card", file=sys.stderr)
        return 1
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip(), flush=True)
    configure_logging()
    n, l, q = DEEP_SHAPE
    t0 = time.perf_counter()
    codes, pairs = planted_family(n, l, q, seed=12, n_pairs=20)
    draw_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ck.identity_counts.launches = 0
    t0 = time.perf_counter()
    inst = PlmDCA(MSA(data=codes, alphabet=alphabets.PROTEIN), "protein",
                  max_iterations=100, verbose=True, device="cuda")
    scores = inst.compute_sorted_FN_APC()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    res, timers = inst.fit_result, inst.timers
    fit_s = timers.elapsed("fit")
    finite = bool(np.isfinite([s for _, s in scores]).all())
    share = planted_recovery(scores, pairs, PLANTED_TOP)
    print(f"deep streamed plm N={n} L={l} q={q}: seq_block {inst.seq_block}; family drawn "
          f"in {draw_s:.2f} s; weights {timers.elapsed('weights'):.3f} s; {fit_text(res, fit_s)}; "
          f"converged {res.converged} linesearch_failed {res.linesearch_failed} "
          f"fx {res.fx:.8g}; score {timers.elapsed('score'):.3f} s; engine wall {wall:.3f} s; "
          f"peak memory {peak:.2f} GiB; {len(scores)} scores, finite {finite}; planted "
          f"recovery {share:.2f} (top {PLANTED_TOP}); identity_counts launches "
          f"{ck.identity_counts.launches}", flush=True)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "n": n, "l": l, "q": q,
        "seq_block": inst.seq_block, "iterations": res.num_iters, "evaluations": res.n_evals,
        "host_syncs": res.host_syncs, "fit_s": fit_s, "s_per_eval": fit_s / res.n_evals,
        "weights_s": timers.elapsed("weights"), "draw_s": draw_s, "peak_gib": peak,
        "fx": res.fx, "converged": res.converged, "planted_recovery": share,
    }), flush=True)
    return 0 if inst.seq_block is not None and finite else 1


if __name__ == "__main__":
    sys.exit(main())
