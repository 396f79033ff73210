"""Where the lock-step family fit's time goes, on one GPU.

    env PYTHONPATH=. python scripts/torch_lockstep_probe.py

Three probes of ``family.family_plm_fit``'s lock-step loop, each beside the
alternative it was chosen over:

1. the per-lane products of ``ops/lbfgs.lbfgs_steps_batch`` (the history
   products ``Z @ g``, ``Z @ Y.T`` and the row dots) at the largest
   protein bucket's (F = 3, D = 1.4e7) and the RNA sweep's (F = 32,
   D = 49140) shapes: ``torch.bmm`` against ``_lane_products``' grouped
   flat GEMM and ``torch.linalg.vecdot`` (CUDA events, 5 calls);
2. one evaluation of the masked lock-step objective of the protein sweep's
   (8192, 256) bucket, its lanes at the bucket's maxima, against the three
   families' own ``plm_loss_and_grad`` at their own shapes (CUDA events, 3
   calls), with the padded and the useful logits-product FLOPs;
3. the m x m solves of ``_compact_coeffs`` on the host: the RNA sweep's
   largest bucket (12 lanes) fitted in lock-step for 20 iterations under
   ``cProfile``, once with ``_host_solve`` (one solve a lane) and once with
   torch's batched CPU solve in its place: the solves' host seconds and
   the fit's wall (the profiler's cost included in both).

Prints the card's name and power limit first.  Needs a CUDA card.
"""

from __future__ import annotations

import cProfile
import pstats
import subprocess
import time

import numpy as np
import torch

from pydca_tpu_torch import alphabets, family, plm
from pydca_tpu_torch.device import set_precision
from pydca_tpu_torch.io.fasta import MSA
from pydca_tpu_torch.ops import lbfgs
from pydca_tpu_torch.synthetic import protein_family_sweep, rna_family_sweep


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def products(dev, m=5):
    for nl, dim in ((3, 14063511), (32, 49140)):
        g = torch.randn(nl, dim, device=dev)
        z = torch.randn(nl, 2 * m, dim, device=dev)
        t = {
            "Z@g bmm": cuda_ms(lambda: torch.bmm(z, g.unsqueeze(2)), 5),
            "Z@g flat": cuda_ms(lambda: lbfgs._lane_products(z, g.unsqueeze(1)), 5),
            "Z@Y.T bmm": cuda_ms(lambda: torch.bmm(z, z[:, m:].transpose(1, 2)), 5),
            "Z@Z.T flat": cuda_ms(lambda: lbfgs._lane_products(z, z), 5),
            "dot bmm": cuda_ms(lambda: torch.bmm(g.unsqueeze(1), g.unsqueeze(2)), 5),
            "dot vecdot": cuda_ms(lambda: lbfgs._rowdot(g, g), 5),
        }
        print(f"(1) {nl} lanes, D {dim}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()),
              flush=True)


def evaluation(dev):
    msas = [c for c, _ in protein_family_sweep()]
    groups = family.bucket_families([MSA(data=c, alphabet=alphabets.PROTEIN) for c in msas])
    idxs = groups[(8192, 256)]
    codes = [torch.from_numpy(msas[i].astype(np.int8)).to(dev) for i in idxs]
    ws = [family._weights_of(c, 0.8, 21) for c in codes]
    lam = np.asarray([0.2 * (c.shape[1] - 1) for c in codes], np.float32)
    fun, x0, _ = family._lockstep_problem(codes, ws, lam, lam, 21)
    lanes = torch.arange(len(codes), device=dev)
    padded = cuda_ms(lambda: fun(x0, lanes), 3)
    own = []
    for c, w, lm in zip(codes, ws, lam):
        n, l = c.shape
        th = plm.init_params(c, w, l, 21)
        own.append(cuda_ms(lambda: plm.plm_loss_and_grad(th, c, w, float(lm), float(lm), l, 21), 3))
    nb, lb = max(c.shape[0] for c in codes), max(c.shape[1] for c in codes)
    flops = lambda n, l: 4.0 * n * (21 * l) ** 2  # the two logits products
    useful = sum(flops(*c.shape) for c in codes)
    print(f"(2) bucket (8192, 256), lanes {[tuple(c.shape) for c in codes]} at ({nb}, {lb}): "
          f"one lock-step evaluation {padded:.2f} ms against the lanes' own "
          f"{' + '.join(f'{t:.2f}' for t in own)} = {sum(own):.2f} ms; products' FLOPs padded "
          f"{len(codes) * flops(nb, lb) / 1e12:.3f} T against useful {useful / 1e12:.3f} T "
          f"(x{len(codes) * flops(nb, lb) / useful:.2f})", flush=True)


def solves(dev):
    msas = [MSA(data=c, alphabet=alphabets.RNA) for c in rna_family_sweep()]
    idxs = max(family.bucket_families(msas).values(), key=len)
    codes = [torch.from_numpy(msas[i].data.astype(np.int8)).to(dev) for i in idxs]
    ws = [family._weights_of(c, 0.8, 5) for c in codes]
    lam = np.asarray([0.2 * (msas[i].seqs_len - 1) for i in idxs], np.float32)
    family._fit_lockstep(codes, ws, lam, lam, 5, max_iterations=3)
    own = lbfgs._host_solve
    out = []
    try:
        for name, solve in (("_host_solve", own), ("batched torch.linalg.solve", torch.linalg.solve)):
            lbfgs._host_solve = solve
            prof = cProfile.Profile()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prof.enable()
            family._fit_lockstep(codes, ws, lam, lam, 5, max_iterations=20)
            prof.disable()
            wall = time.perf_counter() - t0
            stats = pstats.Stats(prof).stats
            calls = sum(v[1] for k, v in stats.items() if "linalg_solve" in k[2])
            secs = sum(v[2] for k, v in stats.items() if "linalg_solve" in k[2])
            out.append(f"{name}: {calls} solve calls {1e3 * secs:.1f} ms of a {1e3 * wall:.1f} ms fit")
    finally:
        lbfgs._host_solve = own
    print(f"(3) the RNA sweep's largest bucket, {len(idxs)} lanes, 20 iterations under cProfile: "
          + "; ".join(out), flush=True)


def main():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    set_precision()
    products(dev)
    evaluation(dev)
    solves(dev)


if __name__ == "__main__":
    main()
