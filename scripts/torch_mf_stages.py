"""Stage times of the port's mean-field path on one GPU.

    env PYTHONPATH=. python scripts/torch_mf_stages.py [N L q]

Drives the engine that ``mfdca compute_fn --apc`` runs,
``MeanFieldDCA(...).compute_sorted_FN_APC()``, on a synthetic planted
family (default N = 4096, L = 1000, q = 21, float32), three times with a
fresh engine, and prints each run's stage timers (weights, gram, corr,
inverse, score: host wall, each stage ending in a synchronise; score holds
the host sort of the pairs) and the mean of the last two (warm) runs.  A
fourth run under torch.profiler gives the device time of all its kernels
and of those that take most of it.  Last, on the engine's own C
(``construct_corr_mat``), CUDA events time ``ops/linalg.spd_inverse`` and
the library Cholesky factor it starts with.  Needs a CUDA card.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch
from torch.autograd import DeviceType

from pydca_tpu_torch.meanfield import MeanFieldDCA
from pydca_tpu_torch.ops import linalg
from pydca_tpu_torch.synthetic import planted_family

STAGES = ("weights", "gram", "corr", "inverse", "score")


def run_once(codes: np.ndarray, biomolecule: str) -> list:
    inst = MeanFieldDCA(codes, biomolecule, device="cuda")
    inst.compute_sorted_FN_APC()
    return [1e3 * inst.timers.elapsed(s) for s in STAGES]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mf_stages: no CUDA card", file=sys.stderr)
        return 1
    n, l, q = (int(a) for a in sys.argv[1:4]) if len(sys.argv) >= 4 else (4096, 1000, 21)
    biomolecule = {21: "protein", 5: "rna"}[q]
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip(), flush=True)
    codes = planted_family(n, l, q, seed=2, n_pairs=20)[0]
    runs = []
    for r in range(3):
        runs.append(run_once(codes, biomolecule))
        torch.cuda.empty_cache()
        print(f"run {r}: " + ", ".join(f"{s} {t:.3f} ms" for s, t in zip(STAGES, runs[-1]))
              + f"; sum {sum(runs[-1]):.3f} ms", flush=True)
    warm = np.mean(runs[1:], axis=0)
    print(f"N={n} L={l} q={q} float32, stage timers, warm (mean of runs 1-2):", flush=True)
    for s, t in zip(STAGES, warm):
        print(f"  {s:8s} {t:9.3f} ms  {100 * t / warm.sum():5.1f}%", flush=True)
    print(f"  {'sum':8s} {warm.sum():9.3f} ms", flush=True)

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run_once(codes, biomolecule)
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.device_time_total, reverse=True)
    total = sum(e.device_time_total for e in kernels) / 1e3
    print(f"run 3 under torch.profiler: device time {total:.3f} ms", flush=True)
    for e in kernels[:8]:
        print(f"  {e.key[:60]:60s} x{e.count} {e.device_time_total / 1e3:9.3f} ms",
              flush=True)

    c = MeanFieldDCA(codes, biomolecule, device="cuda").construct_corr_mat()
    for name, fn in (("linalg.spd_inverse", lambda: linalg.spd_inverse(c)),
                     ("torch.linalg.cholesky_ex", lambda: torch.linalg.cholesky_ex(c))):
        ms = []
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        print(f"  {name:26s} on C {c.shape[0]}^2: {', '.join(f'{t:.3f}' for t in ms)} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
