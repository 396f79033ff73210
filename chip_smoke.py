"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pydca_tpu_torch/csrc`` with nvcc
(one process per source, in parallel) and, for each of the two paths:

- plmDCA: checks ``identity_counts`` against its plain PyTorch version on
  the card, with a library matmul and the bound at the main shape (phase
  2), drives ``plmdca compute_fn --apc`` at PF02826 width
  (N = 16384, L = 195, q = 21; phase 3) and compares a CPU and a GPU run of
  the same RNA-shaped family (phase 4);
- mean-field: checks ``weighted_gram`` against its plain version and times
  it beside one library matmul and its bound (phase 5), drives ``mfdca
  compute_fn --apc`` at protein scale (N = 4096, L = 1000, q = 21; phase 6)
  and compares a CPU and a GPU run of a PF02826-width family (phase 7).

One line per phase; the next-to-last line is the kernel record (JSON), the
last line the device record (JSON).  Exits non-zero, with no result, when
there is no card or any phase fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pydca_tpu_torch import alphabets
from pydca_tpu_torch.cli import mfdca_main, plmdca_main
from pydca_tpu_torch.device import set_precision
from pydca_tpu_torch.ops import _build
from pydca_tpu_torch.ops import cuda_kernels as ck
from pydca_tpu_torch.synthetic import (
    PLANTED_MIN_SHARE, PLANTED_TOP, planted_family, planted_recovery,
    spearman, top_k_overlap, write_family_fasta,
)

KERNELS = ("identity_counts", "weighted_gram")
REPLACES = {  # the TPU kernel each one replaces (its def line)
    "identity_counts": "pydca_tpu/ops/pallas_kernels.py:79",
    "weighted_gram": "pydca_tpu/ops/pallas_kernels.py:176",
}
MAIN_SHAPE = (16384, 195, 21)  # PF02826 width at the depth of a deep family
RNA_SHAPE = (2704, 102, 5)  # RF00167 shape
PF_SHAPE = (2030, 195, 21)  # PF02826 shape
MF_SHAPE = (4096, 1000, 21)  # the JAX package's protein-scale mean-field shape
PEAK = {  # NVIDIA H100 SXM data sheet, dense, at its 700 W power limit
    "bf16": 989e12, "f64_tensor": 67e12, "int8": 1979e12, "bytes": 3.35e12,
    "f32": 67e12, "f64": 34e12,  # outside the tensor cores
}
GRAM_TOL = {  # (rtol, atol) on the Meff-normalised Gram
    torch.float32: (1e-5, 1e-6),
    torch.float64: (1e-12, 1e-15),
}
# largest relative error of the float32 Gram against float64 on the same
# weights: three bf16 pieces give ~4e-7 (as cuBLAS fp32 does), dropping the
# third gives ~7e-6 (tests/test_torch_weighted_gram.py)
GRAM_REL_F64 = 2e-6


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def edge_family(dev):
    """L = 100 rows sharing exactly 57 positions with a base row: at seqid
    0.57 the float32 threshold (57.0) rejects them, float64 (56.99..) not."""
    rng = np.random.default_rng(5)
    l, q = 100, 5
    base = rng.integers(0, q, size=l)
    rows = [base]
    for _ in range(300):
        row = base.copy()
        flip = rng.choice(l, size=43, replace=False)
        row[flip] = (row[flip] + rng.integers(1, q, size=43)) % q
        rows.append(row)
    codes = np.stack(rows)
    ident = (codes[:, None, :] == codes[None, :, :]).sum(-1)
    check(not np.array_equal((ident > np.float32(0.57 * l)).sum(1),
                             (ident > 0.57 * l).sum(1)),
          "edge family does not separate the float32 and float64 thresholds")
    return torch.tensor(codes.astype(np.int8), device=dev), l, q


def phase_kernel(dev):
    """Kernel vs plain version: exact equality at every shape; times."""
    cases = []
    for name, (n, l, q) in (("rf00167", RNA_SHAPE), ("pf02826_deep", MAIN_SHAPE),
                            ("ragged", (1000, 97, 21))):
        codes, _ = planted_family(n, l, q, seed=n)
        cases.append((name, torch.tensor(codes, device=dev), 0.8 * l, q, None))
    codes, l, q = edge_family(dev)
    cases.append(("f32_edge", codes, 0.57 * l, q, None))
    rng = np.random.default_rng(9)
    rna = cases[0][1]
    valid = torch.tensor(rng.random(rna.shape[0]) > 0.3, device=dev)
    cases.append(("valid_mask", rna, 0.8 * rna.shape[1], 5, valid))

    max_err, timing = 0, {}
    for name, codes, thr, q, valid in cases:
        got = ck.identity_counts(codes, thr, q, valid=valid)
        want = ck.identity_counts_reference(codes, thr, q, valid=valid)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"kernel != plain on {name}")
        err = int((got - want).abs().max())
        max_err = max(max_err, err)
        big = codes.shape[0] >= 10000
        ms = cuda_ms(lambda: ck.identity_counts(codes, thr, q, valid=valid), 5 if big else 20)
        plain_ms = cuda_ms(
            lambda: ck.identity_counts_reference(codes, thr, q, valid=valid), 3 if big else 10
        )
        n, l = codes.shape
        extra = ""
        lib_ms = bound = None
        if name == "pf02826_deep":  # the library call and the bound of the main-path shape
            x = torch.nn.functional.one_hot(codes.long(), q).float().reshape(n, l * q)
            lib_ms = cuda_ms(lambda: x @ x.T, 3)
            del x
            torch.cuda.empty_cache()
            bound = identity_bound(n, l, q)
            extra = f", library {lib_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})"
        timing[name] = (ms, plain_ms, lib_ms, bound)
        print(f"phase 2 kernel {name} N={n} L={l} q={q} valid={valid is not None}: "
              f"equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{extra}", flush=True)
    return max_err, timing


def identity_bound(n, l, q):
    """The least time of the identity counts on an H100 (700 W): the
    larger of the N(N+1)/2 row pairs' one-hot products (L*q int8 multiply-
    adds each) at 1979 TOP/s and reading the N*L code bytes at 3.35 TB/s."""
    return bound_of(n * (n + 1) / 2 * l * q * 2 / PEAK["int8"], n * l / PEAK["bytes"])


def reset_launches() -> None:
    for name in KERNELS:
        getattr(ck, name).launches = 0


def gram_bound(n, l, q, dtype):
    """The least time of the Gram on an H100 (700 W): the larger of its
    non-zero products, one add per sequence and site pair on the upper
    triangle (N*L*(L+1)/2, an FMA's 2 flop each at the float32 or float64
    rate outside the tensor cores), and its bytes (codes and weights read,
    K^2 elements written) at 3.35 TB/s."""
    item = 4 if dtype == torch.float32 else 8
    adds = n * l * (l + 1) / 2
    return bound_of(2 * adds / PEAK["f32" if item == 4 else "f64"],
                    (n * l + n * item + (l * q) ** 2 * item) / PEAK["bytes"])


def gram_dense_bound(n, k, dtype):
    """The same for the dense one-hot product the kernel runs: the upper
    triangle's N*K*(K+1) flop as three exact bf16 tensor-core passes at 989
    TFLOP/s (f32), or once at the 67 TFLOP/s of the f64 tensor cores."""
    flop = n * k * (k + 1)
    if dtype == torch.float32:
        return bound_of(3 * flop / PEAK["bf16"], k * k * 4 / PEAK["bytes"])
    return bound_of(flop / PEAK["f64_tensor"], k * k * 8 / PEAK["bytes"])


def bound_of(op_s: float, byte_s: float):
    """(ms, what bounds it) from the operations' and the bytes' seconds."""
    return (1e3 * op_s, "operations") if op_s >= byte_s else (1e3 * byte_s, "bytes")


def device_ms(fn, names, reps: int) -> float:
    """Device milliseconds per call of the kernels whose names contain one
    of ``names`` (torch.profiler), without the wrapper's host time."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages()
                if any(m in e.key for m in names))
    return total / reps / 1e3


def rel_err_f64(got, want64) -> float:
    """Largest |got - want| / |want| over the non-zero elements."""
    nz = want64 != 0
    return float(((got.double() - want64).abs_()[nz] / want64[nz]).max())


def phase_gram(dev):
    """weighted_gram kernel vs plain version: the same zero pattern, the
    rest within GRAM_TOL[dtype] of the Meff-normalised Gram, bitwise
    symmetric and the same in two runs, and at RF00167 and PF02826 shape
    within GRAM_REL_F64 of float64; times beside the library call (one
    matmul on the prebuilt one-hot) and the bounds."""
    cases = [("rf00167", RNA_SHAPE, torch.float32), ("pf02826", PF_SHAPE, torch.float32),
             ("ragged", (1000, 97, 21), torch.float32), ("protein", MF_SHAPE, torch.float32),
             ("f64", (300, 61, 21), torch.float64)]
    max_err, timing = 0.0, {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, (n, l, q), dtype in cases:
        codes = torch.tensor(planted_family(n, l, q, seed=n + l, n_pairs=0)[0], device=dev)
        rng = np.random.default_rng(n)
        w = torch.tensor(rng.uniform(0.05, 1.0, n), dtype=dtype, device=dev)
        got = ck.weighted_gram(codes, w, q)
        again = ck.weighted_gram(codes, w, q)
        want = ck.weighted_gram_reference(codes, w, q)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"weighted_gram differs between two runs on {name}")
        check(torch.equal(got, got.T), f"weighted_gram is not symmetric on {name}")
        del again
        check(torch.equal(got == 0, want == 0), f"weighted_gram zero pattern differs on {name}")
        rel = ""
        if name in ("rf00167", "pf02826"):  # what fp32 accumulation costs, both ways
            want64 = ck.weighted_gram_reference(codes, w.double(), q)
            kernel_rel = rel_err_f64(got, want64)
            rel = (f"largest relative error vs float64: kernel {kernel_rel:.3e} "
                   f"(limit {GRAM_REL_F64}), cuBLAS fp32 {rel_err_f64(want, want64):.3e}; ")
            del want64
            check(kernel_rel <= GRAM_REL_F64,
                  f"weighted_gram relative error vs float64 {kernel_rel:.3e} on {name}")
        meff = w.sum()
        rtol, atol = GRAM_TOL[dtype]
        err = (got.div_(meff) - want.div_(meff)).abs_()
        bad = int((err > atol + rtol * want.abs()).sum())
        case_err = float(err.max())
        max_err = max(max_err, case_err)
        del got, want, err
        check(bad == 0, f"weighted_gram differs from plain on {name}: {bad} elements")
        big = n * l >= 10**6
        reps = 5 if big else 20
        x = torch.nn.functional.one_hot(codes.long(), q).to(dtype).reshape(n, l * q)
        xw = x * w[:, None]
        kernel = lambda: ck.weighted_gram(codes, w, q)
        library = lambda: torch.matmul(xw.T, x)
        turns = (library, kernel, kernel, library)
        lib_a, ms_a, ms_b, lib_b = (cuda_ms(f, reps) for f in turns)
        ms, lib_ms = (ms_a + ms_b) / 2, (lib_a + lib_b) / 2
        del x, xw
        dev_ms = device_ms(kernel, ("gram_", "transpose_codes"), reps)
        plain_ms = cuda_ms(lambda: ck.weighted_gram_reference(codes, w, q), 3 if big else 10)
        bound = gram_bound(n, l, q, dtype)
        dense = gram_dense_bound(n, l * q, dtype)
        timing[name] = (ms, plain_ms, lib_ms, bound)
        torch.cuda.empty_cache()
        print(f"phase 5 weighted_gram {name} N={n} L={l} q={q} {str(dtype)[6:]} "
              f"splits {ck._gram_plan(n, l * q, sms, w.element_size())[0]}: "
              f"zeros equal, symmetric, same in two runs; {rel}"
              f"max abs err {case_err:.3e} (rtol {rtol}, atol {atol}), "
              f"kernel {ms:.4f} ms ({ms_a:.4f}, {ms_b:.4f}; device {dev_ms:.4f}), "
              f"library {lib_ms:.4f} ms ({lib_a:.4f}, {lib_b:.4f}), plain {plain_ms:.4f} ms, "
              f"bound {bound[0]:.4f} ms by {bound[1]} ({100 * bound[0] / ms:.1f}% of it), "
              f"dense-formulation bound {dense[0]:.4f} ms by {dense[1]} "
              f"({100 * dense[0] / ms:.1f}% of it)", flush=True)
    return max_err, timing


def run_mf_cli(biomolecule, fa, out_dir, device):
    inst = mfdca_main.run_meanfield_dca([
        "compute_fn", biomolecule, fa, "--apc", "--device", device, "--output_dir", out_dir,
    ])
    stem = os.path.splitext(os.path.basename(fa))[0]
    return inst, read_scores(os.path.join(out_dir, f"MFDCA_apc_fn_scores_{stem}.txt"))


def phase_meanfield(tmp):
    """``mfdca compute_fn --apc`` at protein scale through both kernels."""
    n, l, q = MF_SHAPE
    codes, pairs = planted_family(n, l, q, seed=2, n_pairs=20)
    fa = os.path.join(tmp, "planted_mf.fa")
    write_family_fasta(fa, codes, alphabets.PROTEIN)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    inst, (header, scores) = run_mf_cli("protein", fa, os.path.join(tmp, "mf"), "cuda")
    wall = time.perf_counter() - t0
    launches = {k: getattr(ck, k).launches for k in KERNELS}
    for k, v in launches.items():
        check(v > 0, f"the mean-field path never launched the {k} kernel")
    # the path's weights (identity_counts at this shape) against the plain counts
    plain_counts = ck.identity_counts_reference(
        torch.from_numpy(inst.msa.data).cuda(), float(np.float32(inst.sequence_identity * l)), q
    )
    check(torch.equal(inst.get_sequences_weight(), 1.0 / plain_counts.to(torch.float32)),
          "mean-field weights differ from the plain identity counts' weights")
    del plain_counts
    check(len(header) > 0, "output has no # header")
    p = l * (l - 1) // 2
    check(len(scores) == p, f"{len(scores)} score lines, expected {p}")
    vals = np.array([s for _, s in scores])
    check(bool(np.isfinite(vals).all()), "non-finite scores")
    check(bool((np.diff(vals) <= 0).all()), "scores not in descending order")
    share = planted_recovery(scores, pairs, PLANTED_TOP)
    check(share >= PLANTED_MIN_SHARE,
          f"planted pairs in top {PLANTED_TOP}: {share:.2f} < {PLANTED_MIN_SHARE}")
    stages = " ".join(f"{s} {inst.timers.elapsed(s):.3f} s"
                      for s in ("weights", "gram", "corr", "inverse", "score"))
    print(f"phase 6 mean-field path N={inst.num_sequences} L={l} q={q}: weights equal to "
          f"plain identity counts'; {len(scores)} pairs, "
          f"planted recovery {share:.2f} (top {PLANTED_TOP}); {stages}; CLI wall {wall:.3f} s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"LU fallback {inst.lu_fallback}; kernel launches {launches}", flush=True)
    return launches["weighted_gram"]


def phase_meanfield_cpu_vs_cuda(tmp):
    """The same PF02826-width family through the mean-field CLI on both devices."""
    n, l, q = PF_SHAPE
    codes, _ = planted_family(n, l, q, seed=3, n_pairs=20)
    fa = os.path.join(tmp, "planted_pf.fa")
    write_family_fasta(fa, codes, alphabets.PROTEIN)
    runs = {}
    for device in ("cpu", "cuda"):
        t0 = time.perf_counter()
        inst, (_, sc) = run_mf_cli("protein", fa, os.path.join(tmp, f"mf_{device}"), device)
        runs[device] = (inst, sc, time.perf_counter() - t0)
    w_cpu = runs["cpu"][0].get_sequences_weight()
    w_gpu = runs["cuda"][0].get_sequences_weight().cpu()
    check(torch.equal(w_cpu, w_gpu), "CPU and GPU weights differ")
    a, b = (dict(runs[d][1]) for d in ("cpu", "cuda"))
    # relative to the largest score: FN-APC values cross zero
    diff = max(abs(a[k] - b[k]) for k in a)
    rel = diff / max(abs(v) for v in a.values())
    rho = spearman(runs["cpu"][1], runs["cuda"][1], l)
    top = top_k_overlap(runs["cpu"][1], runs["cuda"][1], 20)
    check(rho >= 0.98 and top >= 0.9,
          f"CPU vs GPU mean-field ranking: spearman {rho:.4f}, top-20 overlap {top:.2f}")
    print(f"phase 7 mean-field cpu vs cuda N={runs['cpu'][0].num_sequences} L={l} q={q}: "
          f"weights equal; spearman {rho:.4f} top-20 overlap {top:.2f}; largest FN-APC "
          f"difference {diff:.3e} (1.583e-04 with the fp32 CUDA-core Gram kernel), "
          f"relative to the largest score {rel:.3e}; "
          f"wall cpu {runs['cpu'][2]:.2f} s cuda {runs['cuda'][2]:.2f} s", flush=True)


def read_scores(path):
    header, scores = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                header.append(line)
            else:
                i, j, s = line.split()
                scores.append(((int(i) - 1, int(j) - 1), float(s)))
    return header, scores


def run_cli(biomolecule, fa, out_dir, device):
    inst = plmdca_main.run_plm_dca([
        "compute_fn", biomolecule, fa,
        "--apc", "--max_iterations", "100", "--device", device,
        "--output_dir", out_dir,
    ])
    stem = os.path.splitext(os.path.basename(fa))[0]
    return inst, read_scores(os.path.join(out_dir, f"PLMDCA_apc_fn_scores_{stem}.txt"))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no card, no result",
              file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    set_precision()

    # ---- phase 1: card and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    fresh = [k for k in KERNELS if not _build.library_path(k).exists()]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source
        for fut in [pool.submit(_build.load, k) for k in KERNELS]:
            fut.result()
    build_s = time.perf_counter() - t0
    print(f"phase 1 torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; nvcc build of {len(fresh)} "
          f"of {len(KERNELS)} kernels in parallel {build_s:.2f} s", flush=True)

    # ---- phase 2: kernel vs plain version on the card
    max_err, timing = phase_kernel(dev)

    with tempfile.TemporaryDirectory() as tmp:
        # ---- phase 3: main path at PF02826 width
        n, l, q = MAIN_SHAPE
        codes, pairs = planted_family(n, l, q, seed=0, n_pairs=20)
        fa = os.path.join(tmp, "planted_protein.fa")
        write_family_fasta(fa, codes, alphabets.PROTEIN)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        inst, (header, scores) = run_cli("protein", fa, os.path.join(tmp, "main"), "cuda")
        launches = ck.identity_counts.launches
        check(launches > 0, "main path never launched the identity_counts kernel")
        res, timers = inst.fit_result, inst.timers
        check(len(header) > 0, "output has no # header")
        check(len(scores) == l * (l - 1) // 2,
              f"{len(scores)} score lines, expected {l * (l - 1) // 2}")
        vals = np.array([s for _, s in scores])
        check(bool(np.isfinite(vals).all()), "non-finite scores")
        check(bool((np.diff(vals) <= 0).all()), "scores not in descending order")
        share = planted_recovery(scores, pairs, PLANTED_TOP)
        check(share >= PLANTED_MIN_SHARE,
              f"planted pairs in top {PLANTED_TOP}: {share:.2f} < {PLANTED_MIN_SHARE}")
        fit_s = timers.elapsed("fit")
        print(f"phase 3 main path N={inst.num_sequences} L={l} q={q}: "
              f"{len(scores)} pairs, planted recovery {share:.2f} (top {PLANTED_TOP}); "
              f"iterations {res.num_iters} converged {res.converged} "
              f"linesearch_failed {res.linesearch_failed} n_evals {res.n_evals}; "
              f"weights {timers.elapsed('weights'):.3f} s fit {fit_s:.3f} s "
              f"score {timers.elapsed('score'):.3f} s; "
              f"{1e3 * fit_s / max(res.num_iters, 1):.2f} ms/iter; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"host syncs/iter {res.host_syncs / max(res.num_iters, 1):.2f}; "
              f"kernel launches {launches}", flush=True)

        # ---- phase 4: the same RNA-shaped family on the CPU and on the card
        n, l, q = RNA_SHAPE
        codes, _ = planted_family(n, l, q, seed=1, n_pairs=20)
        fa = os.path.join(tmp, "planted_rna.fa")
        write_family_fasta(fa, codes, alphabets.RNA)
        runs = {}
        for device in ("cpu", "cuda"):
            t0 = time.perf_counter()
            inst, (_, sc) = run_cli("rna", fa, os.path.join(tmp, device), device)
            runs[device] = (inst, sc, time.perf_counter() - t0)
        w_cpu = runs["cpu"][0].compute_seqs_weight()
        w_gpu = runs["cuda"][0].compute_seqs_weight().cpu()
        check(torch.equal(w_cpu, w_gpu), "CPU and GPU weights differ")
        rho = spearman(runs["cpu"][1], runs["cuda"][1], l)
        top = top_k_overlap(runs["cpu"][1], runs["cuda"][1], 20)
        check(rho >= 0.98 and top >= 0.9,
              f"CPU vs GPU ranking: spearman {rho:.4f}, top-20 overlap {top:.2f}")
        print(f"phase 4 cpu vs cuda N={runs['cpu'][0].num_sequences} L={l} q={q}: "
              f"weights equal; spearman {rho:.4f} top-20 overlap {top:.2f}; "
              f"iterations cpu {runs['cpu'][0].fit_result.num_iters} "
              f"cuda {runs['cuda'][0].fit_result.num_iters}; wall cpu "
              f"{runs['cpu'][2]:.2f} s cuda {runs['cuda'][2]:.2f} s", flush=True)

        # ---- phases 5-7: the mean-field path
        gram_err, gram_timing = phase_gram(dev)
        mf_launches = phase_meanfield(tmp)
        phase_meanfield_cpu_vs_cuda(tmp)

    records = []
    for name, (ms, plain_ms, lib_ms, bound), n_launch, err in (
        ("identity_counts", timing["pf02826_deep"], launches, max_err),
        ("weighted_gram", gram_timing["protein"], mf_launches, gram_err),
    ):
        records.append({
            "name": name, "route": "cuda", "source": f"pydca_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": n_launch, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": lib_ms,
        })
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
