"""weighted_gram's time against the number of split-N chunks, on one GPU.

    env PYTHONPATH=. python scripts/torch_gram_splits.py

At the small-K shapes where ``ops/cuda_kernels._gram_plan`` cuts the
sequences into chunks (RF00167 shape 2704 x 102, q = 5; 2000 x 26, q = 5;
1000 x 97, q = 21), runs ``weighted_gram`` with the plan forced to each of
several chunk counts, the plan's own choice marked ``*``, checks each
result against the plain version (chip_smoke's GRAM_TOL), and prints the
device time of its kernels (torch.profiler) and the wrapper's time per call
(CUDA events), 20 calls each.  Needs a CUDA card.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from chip_smoke import GRAM_TOL, cuda_ms, device_ms
from pydca_tpu_torch.device import set_precision
from pydca_tpu_torch.ops import cuda_kernels as ck
from pydca_tpu_torch.synthetic import planted_family

SHAPES = ((2704, 102, 5), (2000, 26, 5), (1000, 97, 21))
COUNTS = (1, 2, 3, 4, 6, 8, 11, 16, 22, 32, 43)


def forced_plans(n, k, sms):
    """(splits, chunk, workspace) for each chunk count in COUNTS that gives
    a distinct plan of whole, non-empty stages."""
    stages = -(-n // ck._GRAM_STAGE)
    side = -(-k // ck._GRAM_TILE)
    tile_bytes = ck._GRAM_TILE ** 2 * 4
    plans = {}
    for want in COUNTS:
        per = -(-stages // min(want, stages))
        s = -(-stages // per)
        plans[s] = (s, per * ck._GRAM_STAGE, s * side * (side + 1) // 2 * tile_bytes if s > 1 else 0)
    return [plans[s] for s in sorted(plans)]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gram_splits: no CUDA card", file=sys.stderr)
        return 1
    set_precision()
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rule = ck._gram_plan
    rtol, atol = GRAM_TOL[torch.float32]
    for n, l, q in SHAPES:
        k = l * q
        codes = torch.tensor(planted_family(n, l, q, seed=n + l, n_pairs=0)[0], device="cuda")
        w = torch.tensor(np.random.default_rng(n).uniform(0.05, 1.0, n), dtype=torch.float32,
                         device="cuda")
        want = ck.weighted_gram_reference(codes, w, q) / w.sum()
        chosen = rule(n, k, sms)
        print(f"{n} x {l}, q {q} (K = {k}): the plan's choice {chosen[0]} chunks", flush=True)
        try:
            for plan in forced_plans(n, k, sms):
                ck._gram_plan = lambda *_, plan=plan: plan
                got = ck.weighted_gram(codes, w, q) / w.sum()
                torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
                fn = lambda: ck.weighted_gram(codes, w, q)
                dev = device_ms(fn, ("gram_", "transpose_codes"), 20)
                wall = cuda_ms(fn, 20)
                mark = "*" if plan[:2] == chosen[:2] else " "
                print(f" {mark} chunks {plan[0]:3d} of {plan[1]:5d} sequences, workspace "
                      f"{plan[2] / 2**20:6.2f} MiB: device {dev:.4f} ms, wrapper {wall:.4f} ms",
                      flush=True)
        finally:
            ck._gram_plan = rule
    return 0


if __name__ == "__main__":
    sys.exit(main())
