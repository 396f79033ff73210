"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pydca_tpu_torch/csrc`` with nvcc
(one process per source, in parallel) and, for each of the two paths:

- plmDCA: checks ``identity_counts`` against its plain PyTorch version on
  the card up to N = 10^5 and times it beside its bound, with a library
  matmul at the main shape (phase 2), drives ``plmdca compute_fn --apc``
  at PF02826 width (N = 16384, L = 195, q = 21; phase 3) and compares a CPU
  and a GPU run of the same RNA-shaped family (phase 4);
- mean-field: checks ``weighted_gram`` against its plain version and times
  it beside one library matmul and its bound (phase 5), drives ``mfdca
  compute_fn --apc`` at protein scale (N = 4096, L = 1000, q = 21; phase 6)
  and compares a CPU and a GPU run of a PF02826-width family (phase 7);
- DI: drives ``plmdca compute_di --apc`` at PF02826 width, deep (phase 8)
  and ``mfdca compute_di --apc`` at protein scale (phase 9), each with the
  two-site fixed point's time, iteration histogram and bound, then holds
  DI-APC on the CPU against the card on the engines of phases 4 and 7 and
  writes ``compute_params`` from their card engines (phase 10);
- streaming of deep alignments: ``plmdca compute_fn --apc`` at PF02826
  width past the 1 GiB logits threshold (N = 70000), where the engine
  streams by itself, held to a fused fit of the same codes and weights on
  the card (phase 11), and ``PlmDCA`` at N = 10^5, L = 1000, q = 21 for two
  iterations, with one streamed evaluation under ``torch.profiler``
  (phase 12);
- checkpoints: fits interrupted at 10 iterations and resumed from their
  npz file to 20 against uninterrupted 20-iteration fits, fused at phase
  3's codes and streamed at phase 11's, and a fit whose third chunk fails
  once, recovered by the bounded retry (phase 13);
- family batches: ``plmdca compute_fn_batch --apc`` and ``mfdca
  compute_fn_batch --apc`` on the JAX package's 32-family RNA sweep, on the
  card and on the CPU, and on 12 planted protein families at Pfam widths
  on the card, each family launching the kernels once, after both kernels
  are held against their plain versions on every family's codes (phase 14);
- reference sequences: ``plmdca compute_fn --apc --refseq_file`` at phase
  3's shape with the card's mapping held to a CPU backmapper's (a),
  ``mfdca compute_fn --apc --refseq_file`` at phase 7's on the card and the
  CPU (b), the batched template search alone on phase 12's codes with 64
  sampled scores held to ``local_align`` (c), ``pydca trim_by_refseq`` and
  ``trim_by_gap_size`` with the search on the card and the CPU (d), and the
  contact evaluator on a synthetic 1000-residue chain holding (a)'s
  planted contacts (e) (phase 15).

One line per phase; the next-to-last line is the kernel record (JSON), the
last line the device record (JSON).  Exits non-zero, with no result, when
there is no card or any phase fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pydca_tpu_torch import align
from pydca_tpu_torch import alphabets
from pydca_tpu_torch import backmap
from pydca_tpu_torch import family
from pydca_tpu_torch import matrices
from pydca_tpu_torch import plm
from pydca_tpu_torch import score
from pydca_tpu_torch import stats
from pydca_tpu_torch.cli import main as pydca_main
from pydca_tpu_torch.cli import mfdca_main, plmdca_main
from pydca_tpu_torch.device import set_precision
from pydca_tpu_torch.eval.pdb import RES_THREE_CHAR_TO_ONE
from pydca_tpu_torch.eval.visualizer import DCAVisualizer
from pydca_tpu_torch.io import output
from pydca_tpu_torch.io.fasta import MSA, write_fasta
from pydca_tpu_torch.ops import _build
from pydca_tpu_torch.ops import cuda_kernels as ck
from pydca_tpu_torch.synthetic import (
    PLANTED_MIN_SHARE, PLANTED_TOP, planted_family, planted_recovery,
    protein_family_sweep, reference_from_row, rna_family_sweep, spearman, top_k_overlap,
    write_family_fasta,
)

KERNELS = ("identity_counts", "weighted_gram")
REPLACES = {  # the TPU kernel each one replaces (its def line)
    "identity_counts": "pydca_tpu/ops/pallas_kernels.py:79",
    "weighted_gram": "pydca_tpu/ops/pallas_kernels.py:176",
}
MAIN_SHAPE = (16384, 195, 21)  # PF02826 width at the depth of a deep family
RNA_DEEP_SHAPE = (100000, 120, 5)  # the JAX package's deep weights shape (bench.py:284)
RNA_SHAPE = (2704, 102, 5)  # RF00167 shape
PF_SHAPE = (2030, 195, 21)  # PF02826 shape
MF_SHAPE = (4096, 1000, 21)  # the JAX package's protein-scale mean-field shape
STREAM_SHAPE = (70000, 195, 21)  # PF02826 width past the 1 GiB logits threshold
DEEP_SHAPE = (100000, 1000, 21)  # deep protein, D = 220300500 parameters
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
    """Kernel vs plain version: exact equality at every shape; times (CUDA
    events with the wrapper, and the device time of its kernels)."""
    cases = []
    for name, (n, l, q) in (("rf00167", RNA_SHAPE), ("pf02826_deep", MAIN_SHAPE),
                            ("ragged", (1000, 97, 21)), ("rna_deep", RNA_DEEP_SHAPE)):
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
        kernel = lambda: ck.identity_counts(codes, thr, q, valid=valid)
        ms = cuda_ms(kernel, 5 if big else 20)
        dev_ms = device_ms(kernel, ("identity_",), 5 if big else 20)
        plain_ms = cuda_ms(
            lambda: ck.identity_counts_reference(codes, thr, q, valid=valid), 3 if big else 10
        )
        n, l = codes.shape
        bound = identity_bound(n, l, q)
        sparse = identity_sparse_bound(n, l, q)
        lib_ms = None
        extra = ""
        if name == "pf02826_deep":  # the library call of the main-path shape
            x = torch.nn.functional.one_hot(codes.long(), q).float().reshape(n, l * q)
            lib_ms = cuda_ms(lambda: x @ x.T, 3)
            del x
            torch.cuda.empty_cache()
            extra = f", library {lib_ms:.4f} ms"
        timing[name] = (ms, plain_ms, lib_ms, bound)
        print(f"phase 2 kernel {name} N={n} L={l} q={q} valid={valid is not None}: "
              f"equal, kernel {ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} ms"
              f"{extra}, bound {bound[0]:.4f} ms by {bound[1]} "
              f"({100 * bound[0] / ms:.1f}% of it), 2:4-sparse formulation {sparse:.4f} ms "
              f"({100 * sparse / ms:.1f}% of it)", flush=True)
    return max_err, timing


def identity_bound(n, l, q):
    """The least time of the identity counts on an H100 (700 W): the
    larger of the N(N+1)/2 row pairs' one-hot products (L*q int8 multiply-
    adds each) at 1979 TOP/s and reading the N*L code bytes at 3.35 TB/s."""
    return bound_of(n * (n + 1) / 2 * l * q * 2 / PEAK["int8"], n * l / PEAK["bytes"])


def identity_sparse_bound(n, l, q):
    """Milliseconds of the same product in a formulation that the data-sheet
    bound leaves out: ordered by (position, state) with q padded to a
    multiple of 4, the one-hot A operand has at most one non-zero in each
    group of 4, which is the 2:4 pattern of the sparse int8 wgmma, at twice
    the dense rate.  A diagnostic printed beside the bound, not the bound."""
    return 1e3 * n * (n + 1) / 2 * l * (-(-q // 4) * 4) * 2 / (2 * PEAK["int8"])


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
    return fa, runs


def check_ranked(scores, l, pairs, what):
    """A ranked score list: every pair once, finite, descending, and the
    planted pairs at the calibrated share among the top."""
    check(len(scores) == l * (l - 1) // 2,
          f"{what}: {len(scores)} score lines, expected {l * (l - 1) // 2}")
    vals = np.array([s for _, s in scores])
    check(bool(np.isfinite(vals).all()), f"{what}: non-finite scores")
    check(bool((np.diff(vals) <= 0).all()), f"{what}: scores not in descending order")
    share = planted_recovery(scores, pairs, PLANTED_TOP)
    check(share >= PLANTED_MIN_SHARE,
          f"{what}: planted pairs in top {PLANTED_TOP}: {share:.2f} < {PLANTED_MIN_SHARE}")
    return share


def two_site_report(inst, q, itemsize):
    """The fixed point of a DI run: iteration histogram, the live pairs at
    each compaction, its bytes bound (each live pair reads its exp(J) block
    and the transpose, 2*q^2 elements, once per iteration, at 3.35 TB/s)
    and its share of the bound; checks that the live counts only fall."""
    st = inst.two_site_stats
    iters = st.iters.cpu().numpy()
    lives = [n for _, n, _ in st.live]
    check(lives == sorted(lives, reverse=True), f"live pair counts rose: {lives}")
    compactions = [(k, n) for (k, n, ws), nxt in zip(st.live, st.live[1:]) if nxt[2] < ws]
    bound_ms = 1e3 * float(iters.sum()) * 2 * q * q * itemsize / PEAK["bytes"]
    fixed_s = inst.timers.elapsed("two_site")
    text = (f"fixed point {fixed_s:.3f} s over {len(iters)} pairs, iterations median "
            f"{np.median(iters):.0f} p99 {np.percentile(iters, 99):.0f} max {iters.max()}, "
            f"{int(iters.sum())} pair-iterations, {len(st.live)} host reads; live pairs "
            f"at each compaction (iteration, live) {compactions}; bound {bound_ms:.4f} ms "
            f"by bytes ({100 * bound_ms / (1e3 * fixed_s):.2f}% of it)")
    return text, bound_ms, compactions


def fixed_point_device(inst, l, q):
    """One more run of the engine's fixed point under torch.profiler: its
    host wall and the device time of all its kernels (ms)."""
    blocks, fi = inst.coupling_blocks(), inst.get_reg_single_site_freqs()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        score.two_site_model_fields(blocks, fi, l, q)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    return wall, sum(e.device_time_total for e in prof.key_averages()) / 1e3


def stage_text(inst, names):
    return " ".join(f"{s} {inst.timers.elapsed(s):.3f} s" for s in names)


def phase_plm_di(tmp):
    """``plmdca compute_di --apc`` at PF02826 width, deep, through the CLI."""
    n, l, q = MAIN_SHAPE
    codes, pairs = planted_family(n, l, q, seed=0, n_pairs=20)
    fa = os.path.join(tmp, "planted_protein_di.fa")
    write_family_fasta(fa, codes, alphabets.PROTEIN)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    inst = plmdca_main.run_plm_dca([
        "compute_di", "protein", fa, "--apc", "--max_iterations", "100",
        "--device", "cuda", "--output_dir", os.path.join(tmp, "plm_di"),
    ])
    wall = time.perf_counter() - t0
    launches = ck.identity_counts.launches
    check(launches > 0, "the plm DI path never launched the identity_counts kernel")
    header, scores = read_scores(os.path.join(tmp, "plm_di", "PLMDCA_apc_di_scores_planted_protein_di.txt"))
    check(len(header) > 0, "output has no # header")
    share = check_ranked(scores, l, pairs, "plm DI-APC")
    res = inst.fit_result
    report, _, _ = two_site_report(inst, q, 4)
    print(f"phase 8 plm DI path N={inst.num_sequences} L={l} q={q}: {len(scores)} pairs, "
          f"planted recovery {share:.2f} (top {PLANTED_TOP}); fit {res.num_iters} iterations "
          f"converged {res.converged}; "
          f"{stage_text(inst, ('weights', 'fit', 'blocks', 'two_site', 'di', 'sort'))}; "
          f"{report}; CLI wall {wall:.3f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel launches "
          f"{{'identity_counts': {launches}}}", flush=True)


def phase_mf_di(tmp):
    """``mfdca compute_di --apc`` at protein scale through the CLI: both
    kernels, the Gram once."""
    n, l, q = MF_SHAPE
    codes, pairs = planted_family(n, l, q, seed=2, n_pairs=20)
    fa = os.path.join(tmp, "planted_mf_di.fa")
    write_family_fasta(fa, codes, alphabets.PROTEIN)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    inst = mfdca_main.run_meanfield_dca([
        "compute_di", "protein", fa, "--apc", "--device", "cuda",
        "--output_dir", os.path.join(tmp, "mf_di"),
    ])
    wall = time.perf_counter() - t0
    launches = {k: getattr(ck, k).launches for k in KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    for k, v in launches.items():
        check(v > 0, f"the mean-field DI path never launched the {k} kernel")
    check(launches["weighted_gram"] == 1,
          f"the mean-field DI path launched weighted_gram {launches['weighted_gram']} times")
    header, scores = read_scores(os.path.join(tmp, "mf_di", "MFDCA_apc_di_scores_planted_mf_di.txt"))
    check(len(header) > 0, "output has no # header")
    share = check_ranked(scores, l, pairs, "mean-field DI-APC")
    report, bound_ms, compactions = two_site_report(inst, q, 4)
    check(len(compactions) > 0, "the protein-scale fixed point never compacted")
    wall_ms, dev_ms = fixed_point_device(inst, l, q)
    stages = ("weights", "gram", "corr", "inverse", "score", "blocks", "two_site", "di", "sort")
    print(f"phase 9 mean-field DI path N={inst.num_sequences} L={l} q={q}: {len(scores)} pairs, "
          f"planted recovery {share:.2f} (top {PLANTED_TOP}); {stage_text(inst, stages)}; "
          f"{report}; again under torch.profiler: wall {wall_ms:.3f} ms, device {dev_ms:.3f} ms "
          f"(idle {100 * (1 - dev_ms / wall_ms):.1f}%, {100 * bound_ms / dev_ms:.2f}% of the "
          f"bound by device time); CLI wall {wall:.3f} s; peak memory {peak:.2f} GiB; "
          f"LU fallback {inst.lu_fallback}; kernel launches {launches}", flush=True)


def count_rows(path):
    with open(path) as fh:
        return sum(1 for line in fh if not line.startswith("#"))


def phase_di_cpu_vs_cuda(tmp, plm_fa, plm_runs, mf_fa, mf_runs):
    """DI-APC of the engines of phases 4 and 7 on the CPU against the card
    (no second fit), then ``compute_params`` from their card engines."""
    parts = []
    for what, runs, l in (("plm", plm_runs, RNA_SHAPE[1]), ("mean-field", mf_runs, PF_SHAPE[1])):
        di = {d: runs[d][0].compute_sorted_DI_APC() for d in ("cpu", "cuda")}
        rho = spearman(di["cpu"], di["cuda"], l)
        top = top_k_overlap(di["cpu"], di["cuda"], 20)
        check(rho >= 0.98 and top >= 0.9,
              f"CPU vs GPU {what} DI-APC: spearman {rho:.4f}, top-20 overlap {top:.2f}")
        a, b = dict(di["cpu"]), dict(di["cuda"])
        diff = max(abs(a[k] - b[k]) for k in a)
        rel = diff / max(abs(v) for v in a.values())
        parts.append(f"{what} L={l}: spearman {rho:.4f} top-20 overlap {top:.2f}, largest "
                     f"DI-APC difference {diff:.3e} ({rel:.3e} of the largest score)")
    for what, cli, fa, runs, l in (("mfdca", mfdca_main, mf_fa, mf_runs, PF_SHAPE[1]),
                                   ("plmdca", plmdca_main, plm_fa, plm_runs, RNA_SHAPE[1])):
        out = os.path.join(tmp, f"{what}_params")
        os.makedirs(out)
        cli.write_outputs(runs["cuda"][0], "compute_params", fa, out)
        stem = os.path.splitext(os.path.basename(fa))[0]
        rows = {k: count_rows(os.path.join(out, f"{k}_{stem}.txt")) for k in ("fields", "couplings")}
        check(rows == {"fields": l, "couplings": l},
              f"{what} compute_params wrote {rows} rows, expected {l} each")
        parts.append(f"{what} compute_params on the card: {rows['fields']} field rows, "
                     f"{rows['couplings']} coupling rows")
    print("phase 10 DI-APC cpu vs cuda; " + "; ".join(parts), flush=True)


def fit_text(res, fit_s):
    """Iterations, evaluations, host syncs per iteration, s per iteration
    and per evaluation, and the fit's wall of one L-BFGS result."""
    iters = max(res.num_iters, 1)
    return (f"{res.num_iters} iterations, {res.n_evals} evaluations, "
            f"{res.host_syncs / iters:.2f} host syncs/iter, {fit_s / iters:.4f} s/iter, "
            f"{fit_s / res.n_evals:.4f} s/eval, fit {fit_s:.3f} s")


def fn_apc_of(x, l, q):
    """Sorted FN-APC of a flat parameter vector on the card."""
    p = l * (l - 1) // 2
    blocks = x[l * q :].reshape(p, q, q)[:, : q - 1, : q - 1]
    return score.sorted_scores(score.apc(score.frobenius_norms(blocks), l), l)


def phase_stream_cli(tmp, dev):
    """``plmdca compute_fn --apc`` past the 1 GiB logits threshold at
    PF02826 width: the engine streams by itself over 2 blocks; then the
    fused loop fits the same codes and weights on the card."""
    n, l, q = STREAM_SHAPE
    codes, pairs = planted_family(n, l, q, seed=11, n_pairs=20)
    fa = os.path.join(tmp, "planted_stream.fa")
    write_family_fasta(fa, codes, alphabets.PROTEIN)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    inst, (header, scores) = run_cli("protein", fa, os.path.join(tmp, "stream"), dev.type)
    wall = time.perf_counter() - t0
    launches = ck.identity_counts.launches
    stream_peak = torch.cuda.max_memory_allocated() / 2**30
    want_block = plm.streaming_block(inst.num_sequences, l, q)
    check(inst.seq_block == want_block == 65552,
          f"streaming route: seq_block {inst.seq_block}, expected 65552")
    check(launches == 1, f"the streamed plm path launched identity_counts {launches} times")
    check(len(header) > 0, "output has no # header")
    share = check_ranked(scores, l, pairs, "streamed plm FN-APC")
    res, timers = inst.fit_result, inst.timers

    msa = torch.from_numpy(inst.msa.data).to(dev)
    weights = inst.compute_seqs_weight()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fused = plm.fit_plm(msa, weights, inst.lambda_h, inst.lambda_J, l, q,
                        max_iterations=inst.max_iterations)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    fused_peak = torch.cuda.max_memory_allocated() / 2**30
    fused_scores = fn_apc_of(fused.x, l, q)
    rho = spearman(scores, fused_scores, l)
    top = top_k_overlap(scores, fused_scores, 20)
    check(rho >= 0.98 and top >= 0.9,
          f"streamed vs fused FN-APC: spearman {rho:.4f}, top-20 overlap {top:.2f}")
    print(f"phase 11 streamed plm path N={inst.num_sequences} L={l} q={q}: seq_block "
          f"{inst.seq_block} ({-(-inst.num_sequences // inst.seq_block)} blocks); "
          f"{len(scores)} pairs, planted recovery {share:.2f} (top {PLANTED_TOP}); "
          f"weights {timers.elapsed('weights'):.3f} s; streamed: {fit_text(res, timers.elapsed('fit'))}, "
          f"peak {stream_peak:.2f} GiB; fused on the card: {fit_text(fused, fused_s)}, "
          f"peak {fused_peak:.2f} GiB; streamed vs fused spearman {rho:.4f} top-20 overlap "
          f"{top:.2f}, fx {res.fx:.6g} vs {fused.fx:.6g}; CLI wall {wall:.3f} s; "
          f"kernel launches {{'identity_counts': {launches}}}", flush=True)
    return inst


def streamed_eval_profile(inst, msa, l, q):
    """One more streamed evaluation at the fitted parameters under
    ``torch.profiler``: host wall ms, device ms, the products' (cuBLAS
    gemm kernels') device ms and the four longest kernels."""
    theta = inst.fit_result.x
    weights = inst.compute_seqs_weight()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        plm.plm_loss_and_grad_chunked(theta, msa, weights, inst.lambda_h, inst.lambda_J,
                                      l, q, inst.seq_block)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    device = sum(e.device_time_total for e in events) / 1e3
    products = sum(e.device_time_total for e in events if "gemm" in e.key.lower()) / 1e3
    top = "; ".join(f"{e.key[:60]} {e.device_time_total / 1e3:.1f} ms" for e in events[:4])
    return wall, device, products, top


def phase_stream_deep(dev):
    """``PlmDCA`` at N = 10^5, L = 1000, q = 21 through the engine, two
    iterations: the streamed route with 8 blocks of 12782 sequences.
    Returns the codes (phase 15 searches them)."""
    n, l, q = DEEP_SHAPE
    t0 = time.perf_counter()
    codes, _ = planted_family(n, l, q, seed=12, n_pairs=20)
    draw_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    inst = plm.PlmDCA(MSA(data=codes, alphabet=alphabets.PROTEIN), "protein",
                      max_iterations=2, device=dev.type)
    scores = inst.compute_sorted_FN_APC()
    wall = time.perf_counter() - t0
    launches = ck.identity_counts.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(inst.seq_block == plm.streaming_block(n, l, q) == 12782,
          f"deep streaming route: seq_block {inst.seq_block}, expected 12782")
    check(launches == 1, f"the deep streamed path launched identity_counts {launches} times")
    p = l * (l - 1) // 2
    check(len(scores) == p, f"deep: {len(scores)} scores, expected {p}")
    check(bool(np.isfinite([s for _, s in scores]).all()), "deep: non-finite scores")
    res, timers = inst.fit_result, inst.timers
    msa = torch.from_numpy(codes).to(dev)
    wall_ms, dev_ms, mm_ms, top = streamed_eval_profile(inst, msa, l, q)
    dim = l * q + p * q * q
    state_gib = (2 * 5 + 2) * dim * 4 / 2**30  # x, g and the 2m = 10 history rows
    bound_ms = 1e3 * 2 * 2 * n * (l * q) ** 2 / PEAK["f32"]
    fit_s = timers.elapsed("fit")
    print(f"phase 12 deep streamed plm N={n} L={l} q={q} D={dim}: seq_block {inst.seq_block} "
          f"({-(-n // inst.seq_block)} blocks); {len(scores)} finite scores; family drawn on "
          f"the host in {draw_s:.2f} s; weights {timers.elapsed('weights'):.3f} s; "
          f"{fit_text(res, fit_s)}; score {timers.elapsed('score'):.3f} s; one evaluation "
          f"again under torch.profiler: wall {wall_ms:.1f} ms, device {dev_ms:.1f} ms, the "
          f"two products {mm_ms:.1f} ms ({100 * mm_ms / dev_ms:.1f}% of the device time; "
          f"longest kernels: {top}); "
          f"flop bound {bound_ms:.1f} ms at 67 TFLOP/s f32 ({100 * bound_ms / wall_ms:.1f}% "
          f"of the evaluation's wall, {100 * bound_ms / (1e3 * fit_s / res.n_evals):.1f}% of "
          f"the fit's s/eval); peak memory {peak:.2f} GiB (state x, g and 10 history rows "
          f"{state_gib:.2f} GiB); engine wall {wall:.3f} s; kernel launches "
          f"{{'identity_counts': {launches}}}", flush=True)
    return codes


class IoClock:
    """Times every checkpoint save and load of ``plm.fit_plm`` (the
    module's ``_save_state`` / ``_load_state`` wrapped in place)."""

    def __init__(self):
        self.saves, self.loads = [], []
        self._real = (plm._save_state, plm._load_state)

        def save(path, state):
            t0 = time.perf_counter()
            self._real[0](path, state)
            self.saves.append(time.perf_counter() - t0)

        def load(path, device):
            t0 = time.perf_counter()
            state = self._real[1](path, device)
            torch.cuda.synchronize()
            self.loads.append(time.perf_counter() - t0)
            return state

        plm._save_state, plm._load_state = save, load

    def close(self):
        plm._save_state, plm._load_state = self._real


class Warnings(logging.Handler):
    """Collects the WARNING records of one logger."""

    def __init__(self, name):
        super().__init__(logging.WARNING)
        self.records, self.logger = [], logging.getLogger(name)
        self.logger.addHandler(self)

    def emit(self, record):
        self.records.append(record.getMessage())

    def close(self):
        self.logger.removeHandler(self)
        super().close()


def resume_case(tmp, name, codes, l, q, lam, block):
    """An uninterrupted 20-iteration fit, a 10-iteration fit that writes
    its checkpoint and a 20-iteration fit that resumes from it; each fit
    takes its weights anew (one identity_counts launch), as the engine
    does.  Chunks and saves every 5 iterations."""
    def fit(iters, path=None):
        weights = stats.sequence_weights(codes, 0.8, q)
        t0 = time.perf_counter()
        res = plm.fit_plm(codes, weights, lam, lam, l, q, max_iterations=iters, chunk_size=5,
                          checkpoint_path=path, checkpoint_every=5, seq_block=block)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    full, full_s = fit(20)
    path = os.path.join(tmp, f"{name}.npz")
    clock = IoClock()
    try:
        part, part_s = fit(10, path)
        size = os.path.getsize(path)
        resumed, resumed_s = fit(20, path)
    finally:
        clock.close()
    check(part.num_iters == 10, f"{name}: the interrupted fit ran {part.num_iters} iterations")
    check(resumed.num_iters == full.num_iters,
          f"{name}: resumed k {resumed.num_iters} != uninterrupted {full.num_iters}")
    bitwise = torch.equal(resumed.x, full.x)
    rel = float(((resumed.x - full.x).abs() / full.x.abs().clamp_min(1e-30)).max())
    check(bitwise or torch.allclose(resumed.x, full.x, rtol=1e-6, atol=0),
          f"{name}: resumed x differs from the uninterrupted fit (largest relative {rel:.3e})")
    saving, ckpt_s = sum(clock.saves), part_s + resumed_s
    text = (f"{name}: file {size / 1e6:.1f} MB, {len(clock.saves)} saves of "
            f"{saving / len(clock.saves):.3f} s, load {clock.loads[0]:.3f} s, resumed at k "
            f"{part.num_iters} to k {resumed.num_iters}, x bitwise {bitwise} (largest relative "
            f"difference {rel:.3e}); checkpointed fits {ckpt_s:.3f} s, saving "
            f"{100 * saving / ckpt_s:.1f}% of it; uninterrupted fit {full_s:.3f} s")
    return full, fit, text


def phase_checkpoint(tmp, dev, main_inst, stream_inst):
    """Checkpoints on the card: resume (fused and streamed) and the
    bounded retry (``plm.fit_plm(checkpoint_path=...)``)."""
    l, q = main_inst.sequences_len, main_inst.num_site_states
    codes = torch.from_numpy(main_inst.msa.data).to(dev)
    torch.cuda.empty_cache()
    reset_launches()
    full, fit, text_a = resume_case(tmp, "fused", codes, l, q, main_inst.lambda_h, None)

    # (b) the third chunk takes two steps, then stops half way through a
    # third (x moved alone) and fails: the state in memory is unusable
    real = plm._plm_fused_steps
    calls = []

    def flaky(st, *args):
        calls.append(1)
        if len(calls) == 3:
            real(st, *args[:-1], 2)
            st.x.mul_(1.5)
            raise RuntimeError("injected device fault")
        return real(st, *args)

    caught = Warnings("pydca_tpu_torch.plm")
    plm._plm_fused_steps = flaky
    try:
        retried, retry_s = fit(20, os.path.join(tmp, "retry.npz"))
    finally:
        plm._plm_fused_steps = real
        caught.close()
    retries = sum("resuming from checkpoint" in m for m in caught.records)
    check(retries == 1, f"retry: {retries} retries logged, expected 1")
    retry_bitwise = torch.equal(retried.x, full.x)
    check(retried.num_iters == full.num_iters
          and (retry_bitwise or torch.allclose(retried.x, full.x, rtol=1e-6, atol=0)),
          "retry: the recovered fit differs from the uninterrupted one")
    del codes
    torch.cuda.empty_cache()

    stream_codes = torch.from_numpy(stream_inst.msa.data).to(dev)
    _, _, text_c = resume_case(tmp, "streamed", stream_codes, stream_inst.sequences_len,
                               stream_inst.num_site_states, stream_inst.lambda_h,
                               stream_inst.seq_block)
    launches = ck.identity_counts.launches
    check(launches == 7, f"checkpoint phase launched identity_counts {launches} times, expected 7")
    print(f"phase 13 checkpoints: (a) {text_a}; (b) retry: chunk 3 failed half way (2 steps "
          f"and x moved alone), {retries} retry from the file, k {retried.num_iters}, x bitwise "
          f"{retry_bitwise}, fit {retry_s:.3f} s; (c) {text_c}; kernel launches "
          f"{{'identity_counts': {launches}}}", flush=True)
    return launches


def write_sweep(tmp, name, codes_list, alphabet):
    os.makedirs(os.path.join(tmp, name))
    files = []
    for k, codes in enumerate(codes_list):
        files.append(os.path.join(tmp, name, f"fam{k:02d}.fa"))
        write_family_fasta(files[-1], codes, alphabet)
    return files


def run_batch(tmp, cli, biomolecule, files, device, flags):
    """One ``compute_fn_batch --apc`` run: its BatchRun, wall, launches,
    peak memory and the score lists of its files in input order."""
    out = os.path.join(tmp, f"{cli}_{biomolecule}_{device}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    argv = ["compute_fn_batch", biomolecule, *files, "--apc", "--device", device,
            "--output_dir", out] + flags
    t0 = time.perf_counter()
    run = (plmdca_main.run_plm_dca if cli == "plmdca" else mfdca_main.run_meanfield_dca)(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: getattr(ck, k).launches for k in KERNELS}
    scores = [read_scores(p)[1] for p in run.paths]
    return run, wall, launches, torch.cuda.max_memory_allocated() / 2**30, scores


def fits_text(run, wall):
    """The fit side of a plm batch: walls, iterations, family-iterations/s
    and per-family ms/iteration."""
    fit_s = sum(f.seconds for f in run.fits)
    iters = sum(f.num_iters for f in run.fits)
    per = sorted(1e3 * f.seconds / max(f.num_iters, 1) for f in run.fits)
    return (f"CLI wall {wall:.3f} s, fit wall {fit_s:.3f} s, {iters} iterations "
            f"({sum(f.n_evals for f in run.fits)} evaluations, "
            f"{sum(f.host_syncs for f in run.fits) / iters:.2f} host syncs/iteration), "
            f"{iters / fit_s:.1f} family-iterations/s, ms/iteration per family min "
            f"{per[0]:.2f} median {float(np.median(per)):.2f} max {per[-1]:.2f}")


def family_busy(msas, dev):
    """The largest family's 20-iteration fit again under ``torch.profiler``:
    host wall ms, device ms and the busy share."""
    msa = max(msas, key=lambda m: m.num_seqs * m.seqs_len)
    l, q = msa.seqs_len, msa.q
    codes = torch.from_numpy(msa.data).to(dev)
    w = family._weights_of(codes, 0.8, q)
    lam = float(np.float32(0.2 * (l - 1)))
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = family._fit_one(codes, w, lam, lam, l, q, max_iterations=20)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    device = sum(e.device_time_total for e in prof.key_averages()) / 1e3
    return (f"the largest family ({msa.num_seqs} x {l}, {st.k} iterations) under "
            f"torch.profiler: wall {wall:.1f} ms, device {device:.1f} ms, busy "
            f"{100 * device / wall:.1f}%")


def family_kernel_checks(msas, dev, what):
    """Both kernels against their plain versions on every family's own
    codes, at the sweep's shapes (partial tiles, N split across the SMs):
    ``identity_counts`` exactly, ``weighted_gram`` on the family path's
    float32 weights with the same zero pattern and within GRAM_TOL of the
    Meff-normalised Gram, as phase 5 holds it.  Returns the largest errors."""
    rtol, atol = GRAM_TOL[torch.float32]
    ident_err, gram_err = 0, 0.0
    for k, msa in enumerate(msas):
        l, q = msa.seqs_len, msa.q
        codes = torch.from_numpy(msa.data.astype(np.int8)).to(dev)
        thr = float(np.float32(0.8 * l))
        counts = ck.identity_counts(codes, thr, q)
        plain = ck.identity_counts_reference(codes, thr, q)
        ident_err = max(ident_err, int((counts - plain).abs().max()))
        check(torch.equal(counts, plain),
              f"{what} family {k} ({msa.num_seqs} x {l}): identity_counts != plain")
        w = family._weights_of(codes, 0.8, q)
        got = ck.weighted_gram(codes, w, q)
        want = ck.weighted_gram_reference(codes, w, q)
        check(torch.equal(got == 0, want == 0),
              f"{what} family {k} ({msa.num_seqs} x {l}): weighted_gram zero pattern differs")
        meff = w.sum()
        err = (got.div_(meff) - want.div_(meff)).abs_()
        bad = int((err > atol + rtol * want.abs()).sum())
        gram_err = max(gram_err, float(err.max()))
        check(bad == 0, f"{what} family {k} ({msa.num_seqs} x {l}): weighted_gram differs "
              f"from plain on {bad} elements")
    return ident_err, gram_err


def phase_families(tmp, dev):
    """``compute_fn_batch --apc`` through both CLIs: the JAX package's RNA
    sweep on the card and on the CPU, then planted protein families."""
    files = write_sweep(tmp, "rna_sweep", rna_family_sweep(), alphabets.RNA)
    nf = len(files)
    batch = family.FamilyBatch([plm.read_msa(f, "rna") for f in files])
    errs = [family_kernel_checks(batch.msas, dev, "RNA sweep")]
    runs = {}
    for device in ("cuda", "cpu"):
        runs[device] = {cli: run_batch(tmp, cli, "rna", files, device, flags)
                        for cli, flags in (("plmdca", ["--max_iterations", "20"]),
                                           ("mfdca", []))}
    plm_gpu, mf_gpu = runs["cuda"]["plmdca"], runs["cuda"]["mfdca"]
    check(plm_gpu[2] == {"identity_counts": nf, "weighted_gram": 0},
          f"RNA plm batch launches {plm_gpu[2]}, expected identity_counts {nf}")
    check(mf_gpu[2] == {"identity_counts": nf, "weighted_gram": nf},
          f"RNA mean-field batch launches {mf_gpu[2]}, expected {nf} of each")
    check(torch.equal(family.family_sequence_weights(batch, device=dev).cpu(),
                      family.family_sequence_weights(batch, device="cpu")),
          "RNA sweep: family weights differ between the card and the CPU")
    worst = {}
    for cli in ("plmdca", "mfdca"):
        pairs = zip(batch.msas, runs["cpu"][cli][4], runs["cuda"][cli][4])
        stats_f = [(spearman(a, b, m.seqs_len), top_k_overlap(a, b, 20)) for m, a, b in pairs]
        worst[cli] = (min(r for r, _ in stats_f), min(t for _, t in stats_f))
        check(worst[cli][0] >= 0.98 and worst[cli][1] >= 0.9,
              f"RNA {cli} batch cpu vs cuda: worst family spearman {worst[cli][0]:.4f}, "
              f"top-20 overlap {worst[cli][1]:.2f}")
    busy = family_busy(batch.msas, dev)
    print(f"phase 14 (a) RNA sweep, {nf} families q 5: on every family identity_counts equal "
          f"to plain, weighted_gram within (rtol, atol) {GRAM_TOL[torch.float32]} of plain "
          f"(max abs err {errs[0][1]:.3e}); weights equal on the card and the CPU; "
          f"plm cuda: {fits_text(plm_gpu[0], plm_gpu[1])}, peak {plm_gpu[3]:.2f} GiB; plm cpu: "
          f"{fits_text(runs['cpu']['plmdca'][0], runs['cpu']['plmdca'][1])}; worst family cpu vs "
          f"cuda plm spearman {worst['plmdca'][0]:.4f} top-20 {worst['plmdca'][1]:.2f}, mean-field "
          f"{worst['mfdca'][0]:.4f} / {worst['mfdca'][1]:.2f}; mean-field CLI wall cuda "
          f"{mf_gpu[1]:.3f} s cpu {runs['cpu']['mfdca'][1]:.3f} s; {busy}; kernel launches plm "
          f"{plm_gpu[2]}, mean-field {mf_gpu[2]}", flush=True)

    sweep = protein_family_sweep()
    files = write_sweep(tmp, "protein_sweep", [c for c, _ in sweep], alphabets.PROTEIN)
    nf = len(files)
    errs.append(family_kernel_checks([plm.read_msa(f, "protein") for f in files], dev,
                                     "protein sweep"))
    torch.cuda.empty_cache()
    plm_run = run_batch(tmp, "plmdca", "protein", files, "cuda", [])
    mf_run = run_batch(tmp, "mfdca", "protein", files, "cuda", [])
    check(plm_run[2] == {"identity_counts": nf, "weighted_gram": 0},
          f"protein plm batch launches {plm_run[2]}, expected identity_counts {nf}")
    check(mf_run[2] == {"identity_counts": nf, "weighted_gram": nf},
          f"protein mean-field batch launches {mf_run[2]}, expected {nf} of each")
    shares = {}
    for cli, run in (("plm", plm_run), ("mean-field", mf_run)):
        shares[cli] = [check_ranked(sc, c.shape[1], pairs, f"protein {cli} family {k}")
                       for k, (sc, (c, pairs)) in enumerate(zip(run[4], sweep))]
    shapes = [c.shape for c, _ in sweep]
    print(f"phase 14 (b) protein sweep, {nf} planted families q 21, N {min(n for n, _ in shapes)}-"
          f"{max(n for n, _ in shapes)}, L {min(l for _, l in shapes)}-{max(l for _, l in shapes)}: "
          f"on every family identity_counts equal to plain, weighted_gram within GRAM_TOL "
          f"(max abs err {errs[1][1]:.3e}); planted recovery min plm {min(shares['plm']):.2f} mean-field "
          f"{min(shares['mean-field']):.2f} (top {PLANTED_TOP}); plm: "
          f"{fits_text(plm_run[0], plm_run[1])}, peak {plm_run[3]:.2f} GiB; mean-field CLI wall "
          f"{mf_run[1]:.3f} s, peak {mf_run[3]:.2f} GiB; kernel launches plm {plm_run[2]}, "
          f"mean-field {mf_run[2]}", flush=True)
    ident = sum(r[2]["identity_counts"] for r in (plm_gpu, mf_gpu, plm_run, mf_run))
    gram = sum(r[2]["weighted_gram"] for r in (mf_gpu, mf_run))
    return ident, gram, max(e[0] for e in errs), max(e[1] for e in errs)


def search_bound(n, w, l_ref):
    """The least time of the template search on an H100 (700 W): 11 float32
    operations a DP cell (Ix: two adds and a max; the diagonal: two maxes;
    H: an add and a max with 0; the row maximum; Iy: a subtract, the prefix
    maximum and an add), none of them an FMA, so at 67e12 / 2 operations/s,
    against reading the N*W template codes (bytes) once."""
    return bound_of(11 * n * w * l_ref / (PEAK["f32"] / 2), n * w / PEAK["bytes"])


def search_profile(ref, temps, dev):
    """One template search on the card under ``torch.profiler``: its
    scores, host wall ms (ending in the scores' copy to the host), device
    ms, CUDA kernels launched and the five longest kernels."""
    sub = matrices.submatrix_for("protein", alphabets.PROTEIN.letters)
    go, ge = matrices.gap_penalties_for("protein")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scores = align.batch_local_align_scores(ref, temps, sub, go, ge,
                                                alphabets.PROTEIN.gap_state, device=dev)
        wall = 1e3 * (time.perf_counter() - t0)
    events = sorted((e for e in prof.key_averages() if e.device_time_total > 0),
                    key=lambda e: -e.device_time_total)
    device = sum(e.device_time_total for e in events) / 1e3
    short = lambda k: k.replace("void ", "").replace("at::native::", "").replace(
        "(anonymous namespace)::", "")[:72]
    top = "; ".join(f"{short(e.key)} {e.device_time_total / 1e3:.1f} ms x{e.count}"
                    for e in events[:5])
    return scores, wall, device, sum(e.count for e in events), top


def stages_text(timers):
    return ", ".join(f"{s} {timers.elapsed(s):.3f} s"
                     for s in ("read", "templates", "search", "align", "map"))


def phase_refseq_plm(tmp, fa, codes, pairs, smi):
    """(a) ``plmdca compute_fn --apc --refseq_file`` at PF02826 width, deep,
    with a reference made from row 137 (substitutions, extended ends); the
    card's mapping against a CPU backmapper's.  Returns what (d) and (e)
    use: the reference file, the DCA file, the reference, the planted pairs
    in reference positions and the identity_counts launches."""
    ref = reference_from_row(codes, 137, alphabets.PROTEIN, seed=15, n_sub=4, ends=(6, 5))
    rf = os.path.join(tmp, "ref_protein.fa")
    write_fasta(rf, ["ref"], [ref])
    out = os.path.join(tmp, "refseq_plm")
    reset_launches()
    t0 = time.perf_counter()
    inst = plmdca_main.run_plm_dca([
        "compute_fn", "protein", fa, "--apc", "--max_iterations", "100", "--refseq_file", rf,
        "--device", "cuda", "--output_dir", out,
    ])
    wall = time.perf_counter() - t0
    launches = ck.identity_counts.launches
    check(launches > 0, "the refseq plm path never launched the identity_counts kernel")
    mapping = inst.refseq_mapping
    rows = list(inst.msa.data)
    bms = {d: backmap.SequenceBackmapper(alignment_data=rows, refseq_file=rf,
                                         biomolecule="protein", device=d) for d in ("cuda", "cpu")}
    maps = {d: bm.map_to_reference_sequence() for d, bm in bms.items()}
    check(list(maps["cuda"].items()) == list(maps["cpu"].items()) == list(mapping.items()),
          "refseq plm: the card's mapping differs from the CPU backmapper's")
    check("search" in bms["cuda"].timers.summary(), "refseq plm: the template search never ran")
    stem = os.path.splitext(os.path.basename(fa))[0]
    dca_file = os.path.join(out, f"PLMDCA_apc_fn_scores_{stem}.txt")
    _, scores = read_scores(dca_file)
    m = len(mapping)
    check(len(scores) == m * (m - 1) // 2, f"refseq plm: {len(scores)} pairs, expected {m * (m - 1) // 2}")
    check(all(0 <= i < j < len(ref) for (i, j), _ in scores), "refseq plm: a pair outside the reference")
    vals = np.array([s for _, s in scores])
    check(bool(np.isfinite(vals).all() and (np.diff(vals) <= 0).all()),
          "refseq plm: scores not finite and descending")
    mapped = [(mapping[i], mapping[j]) for i, j in pairs if i in mapping and j in mapping]
    share = planted_recovery(scores, mapped, PLANTED_TOP)
    check(share >= PLANTED_MIN_SHARE,
          f"refseq plm: mapped planted pairs in top {PLANTED_TOP}: {share:.2f}")
    bm = bms["cuda"]
    temps = backmap.templates_from_codes(torch.from_numpy(inst.msa.data).cuda(),
                                         alphabets.PROTEIN.gap_state)
    ref_codes = alphabets.PROTEIN.encode_str(ref)
    search = lambda: align.batch_local_align_scores(
        ref_codes, temps, matrices.submatrix_for("protein", alphabets.PROTEIN.letters),
        *matrices.gap_penalties_for("protein"), alphabets.PROTEIN.gap_state, device="cuda")
    search_ms = cuda_ms(search, 5)
    n, w = temps.shape
    bound = search_bound(n, w, len(ref))
    print(f"phase 15 (a) [{smi}] plmdca compute_fn --apc --refseq_file N={inst.num_sequences} "
          f"L={inst.sequences_len} q=21, reference of {len(ref)} residues from row 137: {m} "
          f"columns mapped, card mapping equal to the CPU backmapper's key for key; {len(scores)} "
          f"pairs over 1..{len(ref)}, descending; {len(mapped)} of {len(pairs)} planted pairs "
          f"mapped, recovery {share:.2f} (top {PLANTED_TOP}); CLI wall {wall:.3f} s, engine "
          f"stage backmap {inst.timers.elapsed('backmap'):.3f} s; card backmapper stages "
          f"{stages_text(bm.timers)}; CPU backmapper search {bms['cpu'].timers.elapsed('search'):.3f} "
          f"s; search alone {search_ms:.3f} ms (CUDA events, N={n} W={w} L_ref={len(ref)}), "
          f"bound {bound[0]:.3f} ms by {bound[1]}; kernel launches "
          f"{{'identity_counts': {launches}}}", flush=True)
    return rf, dca_file, ref, [p for p in mapped if p[1] - p[0] > 4], launches


def phase_refseq_mf(tmp, fa, runs, smi):
    """(b) ``mfdca compute_fn --apc --refseq_file`` at PF02826 shape on the
    card and the CPU: the same mapped pairs, the rank bar, equal weights."""
    codes = runs["cpu"][0].msa.data
    ref = reference_from_row(codes, 41, alphabets.PROTEIN, seed=16, n_sub=3, ends=(4, 7))
    rf = os.path.join(tmp, "ref_pf.fa")
    write_fasta(rf, ["ref"], [ref])
    res = {}
    for device in ("cpu", "cuda"):
        reset_launches()
        t0 = time.perf_counter()
        inst = mfdca_main.run_meanfield_dca([
            "compute_fn", "protein", fa, "--apc", "--refseq_file", rf, "--device", device,
            "--output_dir", os.path.join(tmp, f"refseq_mf_{device}"),
        ])
        wall = time.perf_counter() - t0
        stem = os.path.splitext(os.path.basename(fa))[0]
        path = os.path.join(tmp, f"refseq_mf_{device}", f"MFDCA_apc_fn_scores_{stem}.txt")
        res[device] = (inst, read_scores(path)[1], wall,
                       {k: getattr(ck, k).launches for k in KERNELS})
    launches = res["cuda"][3]
    for k, v in launches.items():
        check(v > 0, f"the refseq mean-field path never launched the {k} kernel")
    check(torch.equal(res["cpu"][0].get_sequences_weight(),
                      res["cuda"][0].get_sequences_weight().cpu()),
          "refseq mean-field: CPU and card weights differ")
    a, b = res["cpu"][1], res["cuda"][1]
    check({p for p, _ in a} == {p for p, _ in b}, "refseq mean-field: mapped pair sets differ")
    check(res["cpu"][0].refseq_mapping == res["cuda"][0].refseq_mapping,
          "refseq mean-field: mappings differ")
    m = len(res["cuda"][0].refseq_mapping)
    check(len(a) == m * (m - 1) // 2, f"refseq mean-field: {len(a)} pairs over {m} sites")
    # Rank over the mapped sites, numbered 0..m-1, so every pair is scored
    # and a NaN on either side still lowers rho.
    rank = {s: r for r, s in enumerate(sorted(res["cuda"][0].refseq_mapping.values()))}
    a_m, b_m = ([((rank[i], rank[j]), s) for (i, j), s in x] for x in (a, b))
    rho, top = spearman(a_m, b_m, m), top_k_overlap(a, b, 20)
    check(rho >= 0.98 and top >= 0.9,
          f"refseq mean-field CPU vs card: spearman {rho:.4f}, top-20 overlap {top:.2f}")
    print(f"phase 15 (b) [{smi}] mfdca compute_fn --apc --refseq_file N="
          f"{res['cuda'][0].num_sequences} L={res['cuda'][0].sequences_len} q=21, reference of "
          f"{len(ref)} residues from row 41: {m} columns mapped, {len(b)} pairs, the same pair "
          f"set and mapping on both devices, weights equal; spearman {rho:.4f} top-20 overlap "
          f"{top:.2f}; wall cpu {res['cpu'][2]:.3f} s cuda {res['cuda'][2]:.3f} s (backmap "
          f"stage {res['cuda'][0].timers.elapsed('backmap'):.3f} s); kernel launches {launches}",
          flush=True)
    return launches


def phase_search_deep(codes, smi, dev):
    """(c) The template search at depth: the codes of phase 12 (10^5 x 1000,
    q 21) and a 1000-residue reference made from row 4242, through a card
    backmapper (every host stage timed), then one more search under
    torch.profiler; 64 sampled templates' scores against ``local_align``."""
    alph = alphabets.PROTEIN
    row_len = int((codes[4242] != alph.gap_state).sum())
    head = (1000 - row_len) // 2
    ref = reference_from_row(codes, 4242, alph, seed=17, n_sub=3,
                             ends=(head, 1000 - row_len - head))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bm = backmap.SequenceBackmapper(alignment_data=list(codes), ref_seq=ref,
                                    biomolecule="protein", device=dev)
    mapping = bm.map_to_reference_sequence()
    wall = time.perf_counter() - t0
    check(len(mapping) >= 0.9 * row_len, f"deep search: {len(mapping)} of {row_len} residues mapped")
    t0 = time.perf_counter()
    strings = alph.decode_many(codes)
    string_bm = backmap.SequenceBackmapper(alignment_data=strings, ref_seq=ref,
                                           biomolecule="protein", device=dev)
    string_temps, _ = string_bm._templates()
    string_s = time.perf_counter() - t0
    del strings, string_bm, string_temps
    temps = backmap.templates_from_codes(torch.from_numpy(codes).to(dev), alph.gap_state)
    n, w = temps.shape
    ref_codes = alph.encode_str(ref)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    scores, wall_ms, dev_ms, kernels, top = search_profile(ref_codes, temps, dev)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    rng = np.random.default_rng(15)
    sample = np.concatenate([[int(np.argmax(scores))], rng.choice(n, size=63, replace=False)])
    sub = matrices.submatrix_for("protein", alph.letters)
    go, ge = matrices.gap_penalties_for("protein")
    temps_host = temps.cpu().numpy()
    for k in sample:
        t = temps_host[k][temps_host[k] != alph.gap_state]
        want = align.local_align(ref_codes, t, sub, go, ge)[0]
        check(scores[k] == want, f"deep search: template {k} scores {scores[k]}, local_align {want}")
    bound = search_bound(n, w, len(ref))
    print(f"phase 15 (c) [{smi}] template search N={n} W={w} L_ref={len(ref)} q=21 (phase 12's "
          f"codes, no cut): 64 sampled scores equal local_align's; backmapper wall {wall:.3f} s "
          f"(stages {stages_text(bm.timers)}; {len(mapping)} of {row_len} row residues mapped); "
          f"the string route's template build (the JAX package's) {string_s:.3f} s; one search "
          f"under torch.profiler: wall {wall_ms:.1f} ms, device {dev_ms:.1f} ms (busy "
          f"{100 * dev_ms / wall_ms:.1f}%), {kernels} kernels ({kernels / len(ref):.1f} a "
          f"reference state; longest: {top}), peak {peak:.2f} GiB beyond the templates; bound "
          f"{bound[0]:.3f} ms by {bound[1]} ({100 * bound[0] / dev_ms:.2f}% of the device time)",
          flush=True)


def phase_trim(tmp, fa, rf, smi):
    """(d) ``pydca trim_by_refseq`` (with and without --remove_all_gaps)
    with the search on the card and on the CPU, byte for byte; and
    ``trim_by_gap_size``."""
    stem = os.path.splitext(os.path.basename(fa))[0]
    parts = []
    for flags in ([], ["--remove_all_gaps"]):
        files, walls = {}, {}
        for device in ("cuda", "cpu"):
            out = os.path.join(tmp, f"trim_{device}_{len(flags)}")
            t0 = time.perf_counter()
            pydca_main.run_pydca(["trim_by_refseq", "protein", fa, rf, "--device", device,
                                  "--output_dir", out] + flags)
            walls[device] = time.perf_counter() - t0
            with open(os.path.join(out, f"Trimmed_{stem}.fa"), "rb") as fh:
                files[device] = fh.read()
        check(files["cuda"] == files["cpu"], f"trim_by_refseq {flags}: card and CPU files differ")
        width = len(files["cuda"].split(b"\n")[1])
        parts.append(f"trim_by_refseq{' --remove_all_gaps' if flags else ''}: files equal, "
                     f"{width} columns kept, wall cuda {walls['cuda']:.3f} s cpu {walls['cpu']:.3f} s")
    out = os.path.join(tmp, "trim_gap")
    pydca_main.run_pydca(["trim_by_gap_size", fa, "--output_dir", out])
    with open(os.path.join(out, f"Trimmed_{stem}.fa")) as fh:
        lines = fh.read().split()
    seqs = lines[1::2]
    gaps = np.mean([[c == "-" for c in s] for s in seqs], axis=0)
    with open(fa) as fh:
        records = sum(line.startswith(">") for line in fh)
    check(len(seqs) == records and bool((gaps <= 0.5).all()),
          "trim_by_gap_size: a record lost or a column above 0.5 gaps kept")
    parts.append(f"trim_by_gap_size: {len(seqs[0])} columns kept")
    print(f"phase 15 (d) [{smi}] " + "; ".join(parts), flush=True)


def write_chain(path, seq, contacts):
    """A protein chain in PDB format: residue k's N, CA, C, O on a 10 A
    grid (no two residues within 8 A), and for each planted pair (a, b) a
    CB on residue a 2 A from residue b's CA."""
    three = {v: k for k, v in RES_THREE_CHAR_TO_ONE.items()}
    partner = dict(contacts)
    lines, serial = [], 1
    for k, letter in enumerate(seq):
        c = 10.0 * np.array([k % 10, (k // 10) % 10, k // 100])
        atoms = [("N", c + [0.4, 0, 0]), ("CA", c), ("C", c + [0, 0.4, 0]), ("O", c + [0, 0, 0.4])]
        if k in partner:
            b = partner[k]
            atoms.append(("CB", 10.0 * np.array([b % 10, (b // 10) % 10, b // 100]) + [1.2, 1.2, 1.0]))
        for name, xyz in atoms:
            lines.append(f"ATOM  {serial:5d} {name:<4s} {three[letter]:>3s} A{k + 1:4d}    "
                         f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}{1.0:6.2f}{0.0:6.2f}"
                         f"          {name[0]:>2s}\n")
            serial += 1
    with open(path, "w") as fh:
        fh.write("".join(lines) + "END\n")


def phase_eval(tmp, rf, dca_file, ref, planted, smi):
    """(e) The evaluator on a synthetic 1000-residue chain holding (a)'s
    reference, with (a)'s planted pairs as its only non-local contacts,
    scored with (a)'s DCA file; both files written with the port's writers."""
    rng = np.random.default_rng(18)
    letters = alphabets.PROTEIN.letters
    head = 1000 - len(ref) - 300
    seq = ("".join(rng.choice(list(letters), size=head)) + ref
           + "".join(rng.choice(list(letters), size=300)))
    pdb = os.path.join(tmp, "chain1000.pdb")
    write_chain(pdb, seq, [(head + i, head + j) for i, j in planted])
    t0 = time.perf_counter()
    viz = DCAVisualizer("protein", "A", pdb, refseq_file=rf, dca_file=dca_file)
    cats = viz.contact_categories()
    rates = viz.compute_true_positive_rates()
    out = os.path.join(tmp, "eval")
    os.makedirs(out)
    meta = pydca_main.get_dcavisualizer_metadata(viz)
    output.write_contact_map(os.path.join(out, "contact_map.txt"), cats, metadata=meta)
    output.write_tp_rate(os.path.join(out, "TPR.txt"), true_positive_rates_dict=rates,
                         metadata=meta[:6])
    host_s = time.perf_counter() - t0
    top = set(viz.dca_ranked_pairs_filtered_by_linear_dist())
    ranked = [p for p in planted if p in top]
    check(len(ranked) >= PLANTED_MIN_SHARE * len(planted) and all(p in cats["tp"] for p in ranked),
          f"evaluator: {sum(p in cats['tp'] for p in ranked)} of {len(ranked)} ranked planted "
          f"pairs are true positives ({len(planted)} planted)")
    check(set(cats["pdb"]) == set(planted), "evaluator: PDB contacts other than the planted pairs")
    print(f"phase 15 (e) [{smi}] evaluator on a {len(seq)}-residue chain ({len(ref)} residues "
          f"from (a)'s reference): {len(ranked)} of {len(planted)} planted pairs ranked in the "
          f"top {len(top)}, all true positives; tp {len(cats['tp'])} fp {len(cats['fp'])} "
          f"missing {len(cats['missing'])} pdb {len(cats['pdb'])}; TPR at rank "
          f"{len(planted)} {rates['dca'][len(planted) - 1]:.3f}; categories, TP rates and both "
          f"files {host_s:.3f} s on the host", flush=True)


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
        main_fa, main_codes, main_pairs = fa, codes, pairs
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        inst, (header, scores) = run_cli("protein", fa, os.path.join(tmp, "main"), "cuda")
        inst_main = inst
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

        plm_fa, plm_runs = fa, runs

        # ---- phases 5-7: the mean-field path
        gram_err, gram_timing = phase_gram(dev)
        mf_launches = phase_meanfield(tmp)
        mf_fa, mf_runs = phase_meanfield_cpu_vs_cuda(tmp)

        # ---- phases 8-10: DI on both paths, compute_params
        phase_plm_di(tmp)
        phase_mf_di(tmp)
        phase_di_cpu_vs_cuda(tmp, plm_fa, plm_runs, mf_fa, mf_runs)

        # ---- phases 11-12: streaming of deep alignments
        stream_inst = phase_stream_cli(tmp, dev)
        deep_codes = phase_stream_deep(dev)

        # ---- phases 13-14: checkpoints, family batches
        ckpt_launches = phase_checkpoint(tmp, dev, inst_main, stream_inst)
        del stream_inst
        fam_ident, fam_gram, fam_ident_err, fam_gram_err = phase_families(tmp, dev)

        # ---- phase 15: reference sequences (backmapping, search, trimming, evaluator)
        rf, dca_file, ref, planted, ref_ident = phase_refseq_plm(
            tmp, main_fa, main_codes, main_pairs, smi)
        ref_mf = phase_refseq_mf(tmp, mf_fa, mf_runs, smi)
        phase_search_deep(deep_codes, smi, dev)
        del deep_codes
        phase_trim(tmp, main_fa, rf, smi)
        phase_eval(tmp, rf, dca_file, ref, planted, smi)

    records = []
    for name, (ms, plain_ms, lib_ms, bound), n_launch, err in (
        ("identity_counts", timing["pf02826_deep"],
         launches + ckpt_launches + fam_ident + ref_ident + ref_mf["identity_counts"],
         max(max_err, fam_ident_err)),
        ("weighted_gram", gram_timing["protein"], mf_launches + fam_gram + ref_mf["weighted_gram"],
         max(gram_err, fam_gram_err)),
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
