"""identity_counts at the deep weights shapes, on one GPU.

    env PYTHONPATH=. python scripts/torch_identity_deep.py

For N = 2*10^5, L = 1000, q = 21 (the JAX package's ``weights_200k_protein``
stage) and N = 10^6, L = 120, q = 5 (its ``weights_1m`` stage, bench.py:308)
it makes a family on the card from a seed (64 ancestors, 10% point
mutations, a tenth of the rows invalid), times
``ops/cuda_kernels.identity_counts`` after a warm-up (CUDA events with the
wrapper, and the device time of its kernels by torch.profiler) beside
``chip_smoke.identity_bound`` and ``chip_smoke.identity_sparse_bound``, and
holds the counts of 2048 evenly spread
rows exactly against the plain counts on those rows:
``((x[rows] @ x.T > thr) & valid).sum(1)`` over the float32 one-hot x
(16.8 GB at the first shape).  Prints the card's name and power limit, one
line per shape and one JSON line; exits 1 if a row differs.  First it
prints what ``nvcc -Xptxas -v`` reports for the kernels (registers, shared
memory, spills) and counts the integer tensor-core instructions (``IGMMA``)
in ``cuobjdump -sass``.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from chip_smoke import cuda_ms, device_ms, identity_bound, identity_sparse_bound
from pydca_tpu_torch.device import set_precision
from pydca_tpu_torch.ops import _build
from pydca_tpu_torch.ops import cuda_kernels as ck

SHAPES = ((200000, 1000, 21), (1000000, 120, 5))  # N, L, q
ROWS = 2048  # rows checked against the plain counts
SEQID = 0.8


def family(n, l, q, seed, dev):
    """(codes (n, l) int8, valid (n,) bool) drawn on the card from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    anc = torch.randint(0, q, (64, l), generator=g, device=dev, dtype=torch.int8)
    codes = anc[torch.randint(0, 64, (n,), generator=g, device=dev)]
    mut = torch.rand((n, l), generator=g, device=dev) < 0.1
    noise = torch.randint(0, q, (n, l), generator=g, device=dev, dtype=torch.int8)
    valid = torch.rand(n, generator=g, device=dev) > 0.1
    return torch.where(mut, noise, codes), valid


def plain_rows(codes, valid, thr, q, rows):
    """The plain counts of ``rows``: one float32 one-hot product."""
    n, l = codes.shape
    x = torch.zeros((n, l, q), dtype=torch.float32, device=codes.device)
    x.scatter_(2, codes.long().unsqueeze(2), 1.0)
    x = x.reshape(n, l * q)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = ((x[rows] @ x.T > thr) & valid[None, :]).sum(1, dtype=torch.int32)
    torch.cuda.synchronize()
    return counts, 1e3 * (time.perf_counter() - t0)


def compiler_report() -> None:
    """ptxas's resource lines for each kernel, and the IGMMA count."""
    nvcc = _build.find_nvcc()
    src = str(_build.CSRC / "identity_counts.cu")
    with tempfile.TemporaryDirectory() as tmp:
        lib = os.path.join(tmp, "libidentity_counts.so")
        proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib, src],
                              capture_output=True, text=True, check=True)
        for line in proc.stderr.splitlines():
            name = re.search(r"Compiling entry function .*\d(identity_[a-z]+_kernel)E", line)
            if name:
                print(f"ptxas {name.group(1)}:", end="")
            elif "spill" in line or "Used" in line:
                print(" " + line.split(":", 1)[-1].strip(), end="" if "spill" in line else "\n")
        cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                              check=True).stdout
    igmma = [ln.split(";")[0].split("*/")[-1].strip() for ln in sass.splitlines() if "IGMMA" in ln]
    print(f"cuobjdump -sass: {len(igmma)} IGMMA instructions, e.g. {igmma[:1]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_identity_deep: no CUDA card", file=sys.stderr)
        return 1
    set_precision()
    dev = torch.device("cuda")
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip(), flush=True)
    compiler_report()
    results = []
    for n, l, q in SHAPES:
        codes, valid = family(n, l, q, seed=n + l, dev=dev)
        thr = float(np.float32(SEQID * l))
        kernel = lambda: ck.identity_counts(codes, thr, q, valid=valid)
        got = kernel()
        ms = cuda_ms(kernel, 3)
        dev_ms = device_ms(kernel, ("identity_",), 3)
        rows = torch.linspace(0, n - 1, ROWS, device=dev).long()
        want, plain_ms = plain_rows(codes, valid, thr, q, rows)
        equal = torch.equal(got[rows], want)
        bound = identity_bound(n, l, q)
        sparse = identity_sparse_bound(n, l, q)
        res = {"n": n, "l": l, "q": q, "equal_on_rows": equal, "rows": ROWS, "ms": ms,
               "device_ms": dev_ms, "bound_ms": bound[0], "bound_by": bound[1],
               "sparse_bound_ms": sparse, "plain_rows_ms": plain_ms,
               "mean_count": float(got.float().mean())}
        results.append(res)
        print(f"identity_counts N={n} L={l} q={q}: {ROWS} rows "
              f"{'equal to' if equal else 'DIFFER from'} the plain counts; kernel {ms:.3f} ms "
              f"(device {dev_ms:.3f}), bound {bound[0]:.3f} ms by {bound[1]} "
              f"({100 * bound[0] / ms:.1f}% of it), 2:4-sparse formulation {sparse:.3f} ms "
              f"({100 * sparse / ms:.1f}% of it); plain on {ROWS} rows {plain_ms:.3f} ms; "
              f"mean count {res['mean_count']:.1f}", flush=True)
        del codes, valid, got, want
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "shapes": results}), flush=True)
    return 0 if all(r["equal_on_rows"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
