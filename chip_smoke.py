"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pydca_tpu_torch/csrc`` with nvcc
(one process per source, in parallel) and, for each of the two paths:

- plmDCA: checks ``identity_counts`` against its plain PyTorch version on
  the card up to N = 10^5 and times it beside its bound, with a library
  matmul at the main shape, and the fused step's passes over the logits,
  ``plm_trial`` and ``plm_update_grad``, against their plain compositions
  at phase 3's and 4's shapes, and the step's L-BFGS algebra beside its
  history (``lbfgs_coeffs``, ``lbfgs_history``, ``lbfgs_finish``) at phase
  3's, each timed beside its byte bound (phase 2),
  drives ``plmdca compute_fn --apc`` at PF02826 width (N = 16384, L = 195,
  q = 21; phase 3) and compares a CPU and a GPU run of the same RNA-shaped
  family (phase 4), each card fit launching the passes once a line-search
  trial and once a gradient, and the L-BFGS kernels once a direction and
  once a step;
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
  are held against their plain versions on every family's codes; on the
  RNA sweep the plm fits also run as one ``--no_bucket`` lock-step batch,
  the largest bucket's lock-step fit under ``torch.profiler`` beside one
  family's, and on both sweeps the sequential per-family loop, every
  family's lock-step scores at the rank bar against its sequential ones
  (phase 14);
- reference sequences: ``plmdca compute_fn --apc --refseq_file`` at phase
  3's shape with the card's mapping held to a CPU backmapper's (a),
  ``mfdca compute_fn --apc --refseq_file`` at phase 7's on the card and the
  CPU (b), the batched template search alone on phase 12's codes with 64
  sampled scores held to ``local_align`` (c), ``pydca trim_by_refseq`` and
  ``trim_by_gap_size`` with the search on the card and the CPU (d), and the
  contact evaluator on a synthetic 1000-residue chain holding (a)'s
  planted contacts (e) (phase 15);
- data parallelism (``torch.distributed``): phase 2 also holds the
  identity-count kernel's tile ranges, split as the ranks split them,
  against the plain partial counts; ``PlmDCA`` and ``MeanFieldDCA`` over a
  one-rank NCCL group on phase 3's and phase 6's codes, bitwise against
  those phases (a); two ranks on the one card (gloo, CUDA tensors staged
  through the host: NCCL refuses two ranks on a card) through both CLIs,
  ``--mesh auto --device cuda:0`` on phase 3's and phase 6's files (b), and
  the deep streamed fit of phase 12 over the same two ranks (c); on a
  machine with two cards or more, (b) under NCCL on two cards (d)
  (phase 16); (b)'s ranks also run ``plmdca`` with ``--precision
  bfloat16``, held to its one-process run of phase 19 at the rank bar.  The ranks are worker processes of
  this script (``chip_smoke.py --phase16-worker <spec> <rank>``) that
  meet at a ``FileStore`` in the temporary directory.  Phase 16 (e) runs (b)'s
  ``plmdca`` argv through ``spawn_cli``, the CLIs' own launch of one rank
  a card from one process, with two gloo ranks on card 0: the file must
  equal (b)'s byte for byte, and the wall beside (b)'s is the launch's cost;
- cold start and ``warmup``: ``plmdca compute_fn --apc`` on phase 3's file
  and ``mfdca compute_fn --apc`` on phase 6's as CLI processes, one of
  each (i) cold (``PYDCA_TPU_CACHE_DIR`` an empty directory: nvcc and g++
  run in the process), (ii) after ``warmup`` into an empty directory, (iii)
  warm, with the split of each process's wall; every file equal to its
  phase's byte for byte (phase 17); ``read_msa`` through the native codec
  against its Python path on phase 3's file and on phase 12's codes as a
  10^5 x 1000 FASTA, arrays and ids equal (phase 18);
- bfloat16 products (run after phase 15, before phase 16, which holds
  its two-rank run to (a)): ``plmdca compute_fn --apc --precision
  bfloat16`` on phase 3's file against phase 3's float32 file at the rank
  bar, with ms per iteration, host syncs, peak memory and both logits
  products in float32 and bfloat16 at phase 3's theta (CUDA events; their
  kernels under ``torch.profiler``) (a); ``PlmDCA(precision="bfloat16")``
  streamed on phase 12's codes for two iterations beside phase 12's
  float32 s per evaluation (c); one bfloat16 evaluation on the card
  against the port's CPU route at the CPU tests' tolerances (d) (phase
  19);
- the model-sharded mean-field solve: ``cholesky_blocked``,
  ``tri_inv_lower`` and ``spd_inverse(chol_block=2048)`` on phase 6's C
  (D = 20000) in one process against ``cholesky_ex``, ``solve_triangular``
  and the engine's ``spd_inverse`` (a); ``mfdca_sharded`` on phase 6's
  codes over a 1 x 2 ('data', 'model') grid of two gloo ranks on card 0
  (worker processes of this script, as in phase 16), at the rank bar
  against phase 6, each rank's rows of the couplings against phase 6's and
  its solve's peak memory below the one-card solve's (b); ``python -m
  pydca_tpu_torch.dryrun --n 4 --device cuda:0``, a 2 x 2 grid of gloo
  ranks on card 0 with the dryrun's three checks (c) (phase 20).

One line per phase and its seconds; the next-to-last line is the kernel record (JSON), the
last line the device record (JSON).  Exits non-zero, with no result, when
there is no card or any phase fails.  Imports nothing of JAX.  The
one-card CLI runs name card 0 (``--device cuda:0``): on a machine with
several cards an unindexed ``cuda`` under the default ``--mesh auto``
would start one rank a card.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

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
from pydca_tpu_torch.io import fasta, output
from pydca_tpu_torch.io.fasta import MSA, write_fasta
from pydca_tpu_torch.meanfield import MeanFieldDCA
from pydca_tpu_torch.native import fastacodec
from pydca_tpu_torch.ops import _build
from pydca_tpu_torch.ops import cuda_kernels as ck
from pydca_tpu_torch.ops import linalg
from pydca_tpu_torch.parallel import (
    init_distributed, make_mesh, mfdca_sharded, shard_msa, spawn_cli,
)
from pydca_tpu_torch.profiling import StageTimers
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
# the fused plm step's passes over the logits (csrc/plm_passes.cu): no TPU
# kernel behind them, XLA fuses the composition they stand for
PLM_PASSES = ("plm_trial", "plm_update_grad")
STANDS_FOR = {
    "plm_trial": "pydca_tpu/plm.py:815 (_phi_dphi)",
    "plm_update_grad": "pydca_tpu/plm.py:841 (_ct_gh), the update of :982",
}
# the fused plm step's L-BFGS algebra beside its history (the same source):
# each kernel, the wrapper that launches it, and what it stands for
LBFGS_ALGEBRA = ("lbfgs_coeffs", "lbfgs_history", "lbfgs_finish")  # the wrappers
LBFGS_KERNELS = {
    "plm_lbfgs_coeffs": ("lbfgs_coeffs", "pydca_tpu/plm.py:996 (direction_coeffs)"),
    "plm_lbfgs_rows": ("lbfgs_history", "pydca_tpu/plm.py:1093, the rows' write"),
    "plm_lbfgs_border": ("lbfgs_history", "pydca_tpu/plm.py:1110-1124, the Gram's border"),
    "plm_lbfgs_finish": ("lbfgs_finish", "pydca_tpu/plm.py:1007, d = -(gamma g + Z^T c)"),
}
LIBRARIES = KERNELS + ("plm_passes",)  # what phase 1 builds
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
        if name in ("pf02826_deep", "rna_deep"):
            extra += tile_range_check(codes, thr, q, want, kernel if name == "pf02826_deep"
                                      else None)
        print(f"phase 2 kernel {name} N={n} L={l} q={q} valid={valid is not None}: "
              f"equal, kernel {ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} ms"
              f"{extra}, bound {bound[0]:.4f} ms by {bound[1]} "
              f"({100 * bound[0] / ms:.1f}% of it), 2:4-sparse formulation {sparse:.4f} ms "
              f"({100 * sparse / ms:.1f}% of it)", flush=True)
    return max_err, timing


def tile_range_check(codes, thr, q, full, kernel) -> str:
    """The kernel over the tile ranges that 2 and 3 ranks take
    (``identity_tile_share``): each range's counts equal the plain partial
    counts of its tiles, and the ranges sum to the full count.  With
    ``kernel`` (the full launch), times one half range beside it."""
    n = codes.shape[0]
    parts = []
    for world in (2, 3):
        total = torch.zeros_like(full)
        for r in range(world):
            tiles = ck.identity_tile_share(n, r, world)
            got = ck.identity_counts(codes, thr, q, tiles=tiles)
            want = ck.identity_counts_reference(codes, thr, q, tiles=tiles)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"tile range {tiles} of {world}: kernel != plain")
            total += got
        check(torch.equal(total, full), f"the {world} tile ranges do not sum to the full count")
        parts.append(f"{world} ranges {[ck.identity_tile_share(n, r, world) for r in range(world)]}")
    text = f"; tile ranges exact and summing to the full count ({', '.join(parts)})"
    if kernel is not None:
        half = ck.identity_tile_share(n, 0, 2)
        half_ms = cuda_ms(lambda: ck.identity_counts(codes, thr, q, tiles=half), 5)
        text += f", half range {half} {half_ms:.4f} ms against the full {cuda_ms(kernel, 5):.4f} ms"
    return text


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
    for name in KERNELS + PLM_PASSES + LBFGS_ALGEBRA:
        getattr(ck, name).launches = 0


def plm_pass_launches(res, what: str) -> dict:
    """The passes' launches since the last reset, checked against one fused
    fit's ``res``: ``plm_trial`` once a line-search trial (``n_evals`` - 1,
    and each first trial queued ahead and thrown away), ``plm_update_grad``
    once a gradient (``num_iters`` + 1); and the L-BFGS algebra's:
    ``lbfgs_history`` (the rows and the border) once a step taken
    (``num_iters``), ``lbfgs_coeffs`` and ``lbfgs_finish`` once a direction:
    one a step that ran, and one queued ahead and thrown away where the fit
    stops on the gradient test before the end of a chunk, so ``num_iters``
    at the iteration cap, one more after a failed line search, and one
    more or none after convergence."""
    got = {k: getattr(ck, k).launches for k in PLM_PASSES + LBFGS_ALGEBRA}
    want = {"plm_trial": res.n_evals - 1 + res.discarded_trials,
            "plm_update_grad": res.num_iters + 1, "lbfgs_history": res.num_iters}
    extra = ({1} if res.linesearch_failed else {0, 1}) if res.converged or \
        res.linesearch_failed else {0}
    check({k: got[k] for k in want} == want and got["lbfgs_finish"] == got["lbfgs_coeffs"]
          and got["lbfgs_coeffs"] - res.num_iters in extra,
          f"{what}: the plm passes launched {got}, expected {want} and "
          f"lbfgs_coeffs = lbfgs_finish = {res.num_iters} + one of {sorted(extra)}")
    return got


EPS32 = 2.0 ** -23  # a float32 ulp at 1


def ulps(got, want, scale) -> float:
    """Largest |got - want| in float32 ulps of ``scale``."""
    return float(((got.double() - want.double()).abs() / (EPS32 * scale.double() + 1e-37)).max())


def plm_pass_problem(n, l, q, seed, dev):
    """Carried logits and picks, a direction and weights on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randint(0, q, (n, l), generator=g, device=dev, dtype=torch.uint8)
    logits = 2.0 * torch.randn((n, q, l), generator=g, device=dev)
    picked = logits.gather(1, codes.long()[:, None, :])[:, 0, :].contiguous()
    return dict(logits=logits, picked=picked,
                u=0.5 * torch.randn((n, q, l), generator=g, device=dev),
                dh=0.3 * torch.randn((l, q), generator=g, device=dev), codes=codes,
                weights=0.05 + 0.95 * torch.rand(n, generator=g, device=dev))


def phase_plm_passes(dev):
    """The fused plm step's two passes against their plain compositions on
    the same card tensors, at the GPU tests' limits (the trial's sums within
    1e-6 of their terms' magnitudes; the updated logits and picks within 2
    float32 ulps, the cotangent within 10 ulps of its terms, its column sums
    within 1e-6 of theirs), two launches equal to the bit, and their times
    (CUDA events with the wrapper; device time by torch.profiler) beside the
    byte bound (each input read once, each output written once) and the
    plain composition's."""
    alpha = 0.37
    worst, timing = {"plm_trial": 0.0, "plm_update_grad": 0.0}, {}
    for name, (n, l, q) in (("pf02826_deep", MAIN_SHAPE), ("rf00167", RNA_SHAPE)):
        p = plm_pass_problem(n, l, q, seed=n + l + q, dev=dev)
        nql = n * q * l
        args = (p["logits"], p["codes"], p["weights"], p["picked"], p["u"], p["dh"], alpha)
        got, again = ck.plm_trial(*args), ck.plm_trial(*args)
        want = ck.plm_trial_reference(*args)
        d = {k: v.double() if v.is_floating_point() else v for k, v in p.items()}
        up = d["u"] + d["dh"].T[None]
        upk = up.gather(1, d["codes"].long()[:, None, :])[:, 0, :]
        t = d["logits"] + alpha * up
        w = d["weights"][:, None]
        sizes = torch.stack(((w * (torch.logsumexp(t, 1) - d["picked"] - alpha * upk)).abs().sum(),
                             (w * ((torch.softmax(t, 1) * up).sum(1) - upk)).abs().sum()))
        del d, up, upk, t
        trial_err = float(((got.double() - want.double()).abs() / sizes).max())
        check(torch.equal(got, again), f"plm_trial {name}: two launches differ")
        check(trial_err <= 1e-6, f"plm_trial {name}: sums off by {trial_err:.3g} of their terms")
        step = (p["u"], p["dh"], alpha)
        runs = []
        for _ in range(2):
            lg, pk = p["logits"].clone(), p["picked"].clone()
            runs.append((lg, pk, *ck.plm_update_grad(lg, p["codes"], p["weights"], pk, *step)))
        check(all(torch.equal(a, b) for a, b in zip(*runs)),
              f"plm_update_grad {name}: two launches differ")
        lg, pk, ct, gh = runs[0]
        del runs
        lg_t, pk_t = p["logits"].clone(), p["picked"].clone()
        ct_t, gh_t = ck.plm_update_grad_reference(lg_t, p["codes"], p["weights"], pk_t, *step)
        errs = (ulps(lg, lg_t, lg_t.abs()), ulps(pk, pk_t, pk_t.abs()),
                ulps(ct, ct_t, ct_t.abs() + p["weights"][:, None, None]))
        gh_err = float(((gh - gh_t).abs() / ct_t.abs().sum(0)).max())
        check(errs[0] <= 2 and errs[1] <= 2 and errs[2] <= 10 and gh_err <= 1e-6,
              f"plm_update_grad {name}: logits {errs[0]:.3g}, picked {errs[1]:.3g}, ct "
              f"{errs[2]:.3g} ulps, gh off by {gh_err:.3g} of its terms")
        del lg, pk, ct, gh, lg_t, pk_t, ct_t, gh_t
        worst["plm_trial"] = max(worst["plm_trial"], trial_err)
        worst["plm_update_grad"] = max(worst["plm_update_grad"], gh_err)
        # times; the update moves the logits by 1e-3 of the direction a call
        small = (p["u"], p["dh"], 1e-3)
        calls = {
            "plm_trial": (lambda: ck.plm_trial(*args), lambda: ck.plm_trial_reference(*args),
                          ("plm_trial",), 4 * (2 * nql + n * l + n + l * q) + n * l + 8),
            "plm_update_grad": (
                lambda: ck.plm_update_grad(p["logits"], p["codes"], p["weights"], p["picked"],
                                           *small),
                lambda: ck.plm_update_grad_reference(p["logits"], p["codes"], p["weights"],
                                                     p["picked"], *small),
                ("plm_update_grad", "plm_gh_reduce"),
                4 * (4 * nql + 2 * n * l + n + 2 * l * q) + n * l),
        }
        for kname, (kernel, plain, names, nbytes) in calls.items():
            ms = cuda_ms(kernel, 20)
            dev_ms = device_ms(kernel, names, 20)
            plain_ms = cuda_ms(plain, 5)
            bound = bound_of(0.0, nbytes / PEAK["bytes"])
            timing[(kname, name)] = (ms, plain_ms, None, bound)
            print(f"phase 2 kernel {kname} {name} N={n} L={l} q={q}: kernel {ms:.4f} ms (device "
                  f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms by "
                  f"{bound[1]} ({100 * bound[0] / dev_ms:.1f}% of it); trial sums off by "
                  f"{trial_err:.3g} of their terms; logits, picked, ct {errs[0]:.2f}, "
                  f"{errs[1]:.2f}, {errs[2]:.2f} ulps, gh off by {gh_err:.3g}; two launches "
                  "equal", flush=True)
        del p, args, calls
        torch.cuda.empty_cache()
    return worst, timing


def lbfgs_problem(k, m, dim, dev, bf16):
    """A history after ``k`` steps (float32, or its rows in bfloat16), the
    gradients ``g`` and ``g'``, and the Gram and projections over it."""
    g = torch.Generator(device=dev).manual_seed(k + 7 * bf16)
    z = torch.zeros((2 * m, dim), device=dev)
    for t in range(max(0, k - m), k):
        s = torch.randn(dim, generator=g, device=dev)
        z[t % m] = s
        z[t % m + m] = 1.3 * s + 0.1 * torch.randn(dim, generator=g, device=dev)
    if bf16:
        z = z.to(torch.bfloat16)
    grad, grad_new = (torch.randn(dim, generator=g, device=dev) for _ in range(2))
    zf = z.float()
    zzt = zf @ zf.T
    del zf
    return z, grad, grad_new, zzt, ck._hist_dot(z, grad)


def phase_lbfgs(dev):
    """The fused plm step's L-BFGS kernels against their plain versions at
    the main path's shape (D = Lq + (Lq)^2 at L = 195, q = 21; m = 5), with
    histories not yet full and wrapped, float32 and bfloat16 rows, and the
    steepest-descent fallback: the coefficients against the CPU's algebra
    (LAPACK's solves) within 1e-4 of each part's largest value, a collapse
    to -g equal; the direction within 2 float32 ulps of its terms; the rows
    equal to the bit and the Gram and projections within 1e-5 of their
    largest value (the card tests' limits), a step not taken leaving all
    as it was.  Then each kernel's time (CUDA events with the wrapper;
    device time by torch.profiler) beside its byte bound (each input read
    once, each output written once) and the plain version's."""
    m, (_, l, q) = 5, MAIN_SHAPE
    lq = l * q
    dim = lq + lq * lq
    worst = dict.fromkeys(LBFGS_KERNELS, 0.0)
    timing = {}
    for name, k, bf16, fallback in (("fresh", 3, False, False), ("wrapped", 13, False, False),
                                    ("fallback", 13, False, True), ("no_update", 12, False, False),
                                    ("bf16_wrapped", 13, True, False)):
        z, g, g_new, zzt, zg = lbfgs_problem(k, m, dim, dev, bf16)
        gg = np.float32(float(torch.dot(g, g)))
        gg_dev = torch.dot(g, g)
        got = ck.lbfgs_coeffs(zg, zzt, gg_dev, k, m)
        want = ck.lbfgs_coeffs_reference(zg.cpu(), zzt.cpu(), gg, k, m)
        coeff_err = max(float((got[a:b].cpu() - want[a:b]).abs().max()
                              / (float(want[a:b].abs().max()) or 1.0))
                        for a, b in ((0, 1), (1, 2), (2, 3), (3, 2 * m + 3)))
        collapse = ck.lbfgs_coeffs(zg, zzt, -gg_dev * 1e3, k, m)
        check(coeff_err <= 1e-4 and torch.equal(
            collapse.cpu(), ck.lbfgs_coeffs_reference(zg.cpu(), zzt.cpu(), -gg * np.float32(1e3),
                                                      k, m)),
              f"plm_lbfgs_coeffs {name}: off by {coeff_err:.3g} of the parts' largest values, "
              "or its collapse to -g differs")
        gamma, cfull = got[0], got[3:]
        zc = plm._hist_combine(cfull, z)
        d = ck.lbfgs_finish(zc.clone(), g, gamma)
        d_want = zc.clone().add_(g, alpha=float(gamma)).neg_()
        fin_err = ulps(d, d_want, (float(gamma) * g).abs() + zc.abs())
        check(fin_err <= 2, f"plm_lbfgs_finish {name}: off by {fin_err:.3g} ulps")
        coeffs = (gamma, cfull)
        if fallback:
            d, coeffs = -g, None
        dg0 = np.float32(float(torch.dot(g, d)))
        dnorm2 = np.float32(float(torch.dot(d, d)))
        alpha = np.float32(1e-20 if name == "no_update" else 0.7)
        args = (g, d, g_new, k, alpha, dg0, dnorm2, gg, coeffs)
        z_got, z_want = z.clone(), z.clone()
        h_got = ck.lbfgs_history(z_got, zzt.clone(), zg.clone(), *args)
        h_want = ck.lbfgs_history_reference(z_want, zzt.clone(), zg.clone(), *args)
        gram_err = max(float((a - b).abs().max() / (float(b.abs().max()) or 1.0))
                       for a, b in zip(h_got, h_want))
        rows_equal = torch.equal(z_got, z_want)
        moved = not torch.equal(z_got, z)
        check(rows_equal and gram_err <= 1e-5 and moved == (name != "no_update")
              and (moved or torch.equal(h_got[0], zzt)),
              f"lbfgs_history {name}: rows equal {rows_equal}, written {moved}, the Gram, "
              f"projections and |g'|^2 off by {gram_err:.3g} of their largest values")
        del z_got, z_want, h_got, h_want, zc, d_want
        worst["plm_lbfgs_coeffs"] = max(worst["plm_lbfgs_coeffs"], coeff_err)
        worst["plm_lbfgs_finish"] = max(worst["plm_lbfgs_finish"], fin_err * EPS32)
        worst["plm_lbfgs_border"] = max(worst["plm_lbfgs_border"], gram_err)
        print(f"phase 2 kernel plm_lbfgs {name} D={dim} m={m} k={k} rows "
              f"{'bfloat16' if bf16 else 'float32'}{' fallback' if fallback else ''}: "
              f"coefficients off by {coeff_err:.3g} of their largest values, collapse equal; "
              f"direction {fin_err:.2f} ulps; rows equal, written {moved}; Gram, projections "
              f"and |g'|^2 off by {gram_err:.3g}", flush=True)
        if name == "wrapped":  # times, on the main path's rows
            gram_b = 4 * (4 * m * m * 2 + 2 * m * 3 + 3)
            zc = plm._hist_combine(cfull, z)
            hist_state = (z.clone(), zzt.clone(), zg.clone())
            zcpu, zzcpu = zg.cpu(), zzt.cpu()
            calls = {
                "plm_lbfgs_coeffs": (
                    lambda: ck.lbfgs_coeffs(zg, zzt, gg_dev, k, m), None,
                    4 * (4 * m * m + 2 * m + 1 + 2 * m + 3)),
                "plm_lbfgs_finish": (
                    lambda: ck.lbfgs_finish(zc, g, gamma),
                    lambda: zc.add_(g, alpha=float(gamma)).neg_(), 4 * 3 * dim),
                "plm_lbfgs_rows": (
                    lambda: ck.lbfgs_history(*hist_state, *args),
                    lambda: ck.lbfgs_history_reference(*hist_state, *args), 4 * 5 * dim),
                "plm_lbfgs_border": (
                    lambda: ck.lbfgs_history(*hist_state, *args),
                    lambda: ck.lbfgs_history_reference(*hist_state, *args), gram_b),
            }
            for kname, (kernel, plain, nbytes) in calls.items():
                ms = cuda_ms(kernel, 20)
                dev_ms = device_ms(kernel, (kname,), 20)
                if plain is None:  # the parent's host algebra, on CPU tensors
                    t0 = time.perf_counter()
                    for _ in range(20):
                        ck.lbfgs_coeffs_reference(zcpu, zzcpu, gg, k, m)
                    plain_ms = 1e3 * (time.perf_counter() - t0) / 20
                else:
                    plain_ms = cuda_ms(plain, 5)
                bound = bound_of(0.0, nbytes / PEAK["bytes"])
                timing[kname] = (ms, dev_ms, plain_ms, bound)
                print(f"phase 2 kernel {kname} D={dim} m={m}: wrapper "
                      f"{LBFGS_KERNELS[kname][0]} {ms:.4f} ms (device {dev_ms:.4f}), plain "
                      f"{plain_ms:.4f} ms, bound {bound[0]:.3g} ms by {bound[1]} "
                      f"({100 * bound[0] / dev_ms:.3g}% of it)", flush=True)
            del hist_state, zc, calls
        del z, g, g_new, zzt, zg, d, args
        torch.cuda.empty_cache()
    worst["plm_lbfgs_rows"] = 0.0  # equal to the bit in every case
    return worst, timing


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


def cli_device(device):
    """The CLIs' ``--device`` for a one-card phase: card 0 by name, since an
    unindexed ``cuda`` under the default ``--mesh auto`` starts one rank a
    card on a machine with several."""
    return "cuda:0" if device == "cuda" else device


def run_mf_cli(biomolecule, fa, out_dir, device):
    inst = mfdca_main.run_meanfield_dca([
        "compute_fn", biomolecule, fa, "--apc", "--device", cli_device(device),
        "--output_dir", out_dir,
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
    # what phase 16 holds its mesh runs to
    ref = dict(fa=fa, weights=inst.get_sequences_weight().cpu(), file_scores=scores,
               scores=inst.compute_sorted_FN_APC(), couplings=digest(inst.compute_couplings()))
    return launches["weighted_gram"], ref


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
        "--device", cli_device("cuda"), "--output_dir", os.path.join(tmp, "plm_di"),
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
        "compute_di", "protein", fa, "--apc", "--device", cli_device("cuda"),
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
    """Iterations, evaluations, host syncs per iteration, discarded
    trials, s per iteration and per evaluation, and the fit's wall of one
    L-BFGS result."""
    iters = max(res.num_iters, 1)
    return (f"{res.num_iters} iterations, {res.n_evals} evaluations, "
            f"{res.host_syncs / iters:.2f} host syncs/iter, "
            f"{res.discarded_trials} discarded trials, {fit_s / iters:.4f} s/iter, "
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


def is_gemm(name: str) -> bool:
    """Whether a kernel's name is one of cuBLAS's GEMM kernels."""
    return any(k in name.lower() for k in ("gemm", "nvjet", "xmma", "cutlass"))


def streamed_eval_profile(inst, msa, l, q, mm_bf16=False):
    """One more streamed evaluation at the fitted parameters under
    ``torch.profiler``: host wall ms, device ms, the products' (cuBLAS
    GEMM kernels') device ms and the four longest kernels."""
    theta = inst.fit_result.x
    weights = inst.compute_seqs_weight()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        plm.plm_loss_and_grad_chunked(theta, msa, weights, inst.lambda_h, inst.lambda_J,
                                      l, q, inst.seq_block, mm_bf16=mm_bf16)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    device = sum(e.device_time_total for e in events) / 1e3
    products = sum(e.device_time_total for e in events if is_gemm(e.key)) / 1e3
    top = "; ".join(f"{e.key[:60]} {e.device_time_total / 1e3:.1f} ms" for e in events[:4])
    return wall, device, products, top


def phase_stream_deep(dev, tmp):
    """``PlmDCA`` at N = 10^5, L = 1000, q = 21 through the engine, two
    iterations: the streamed route with 8 blocks of 12782 sequences.
    Returns the codes (phases 15 and 19 read them) and the fit's s per
    evaluation; saves the codes, the weights and theta in ``tmp``
    (``deep_*.npy``) for phase 16."""
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
    for name, a in (("codes", codes), ("weights", inst.compute_seqs_weight().cpu().numpy()),
                    ("theta", res.x.cpu().numpy())):
        np.save(os.path.join(tmp, f"deep_{name}.npy"), a)
    return codes, fit_s / res.n_evals


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
    out = os.path.join(tmp, f"{cli}_{biomolecule}_{device}" + "".join(
        f.strip("-") for f in flags if f.startswith("--no")))
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
    """The fit side of a plm batch: walls, family-iterations/s, host syncs
    a family-iteration, lane-iterations run against useful ones and each
    lock-step batch's lanes, (N, L), seconds and host syncs."""
    fit_s = sum(b.seconds for b in run.batches)
    iters = sum(f.num_iters for f in run.fits)
    per = "; ".join(f"{b.lanes} x {b.shape} {b.seconds:.3f} s {b.host_syncs} syncs"
                    for b in run.batches)
    return (f"CLI wall {wall:.3f} s, fit wall {fit_s:.3f} s, {iters} family-iterations "
            f"({sum(f.n_evals for f in run.fits)} evaluations), {iters / fit_s:.1f} "
            f"family-iterations/s, {sum(b.host_syncs for b in run.batches) / iters:.2f} host "
            f"syncs/family-iteration, lane-iterations run "
            f"{sum(b.lane_iterations for b in run.batches)} against {iters} useful, "
            f"{len(run.batches)} lock-step batches ({per})")


def sequential_fits(msas, dev, iters):
    """The per-family reference loop, ``family._fit_one`` on each family
    one after another (weights first, as the lock-step route has them):
    the score lists and a text with the fit wall (each fit ending in a
    synchronise), family-iterations/s, host syncs a family-iteration and
    peak memory."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    scores, fit_s, k, syncs = [], 0.0, 0, 0
    for msa in msas:
        l, q = msa.seqs_len, msa.q
        codes = torch.from_numpy(msa.data.astype(np.int8)).to(dev)
        w = family._weights_of(codes, 0.8, q)
        lam = float(np.float32(0.2 * (l - 1)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = family._fit_one(codes, w, lam, lam, l, q, max_iterations=iters)
        torch.cuda.synchronize()
        fit_s += time.perf_counter() - t0
        k, syncs = k + st.k, syncs + st.host_syncs
        scores.append(family._own_scores(st.x, l, q, True))
        del st, codes, w
    peak = torch.cuda.max_memory_allocated() / 2**30
    return scores, (f"fit wall {fit_s:.3f} s, {k} family-iterations, {k / fit_s:.1f} "
                    f"family-iterations/s, {syncs / k:.2f} host syncs/family-iteration, "
                    f"peak {peak:.2f} GiB")


def busy_text(fit, what):
    """``fit()`` under ``torch.profiler`` (CUDA only): host wall ms, device
    ms and the busy share."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    device = sum(e.device_time_total for e in prof.key_averages()) / 1e3
    return f"{what} under torch.profiler: wall {wall:.1f} ms, device {device:.1f} ms, busy " \
           f"{100 * device / wall:.1f}%"


def family_busy(msas, dev):
    """The largest family's 20-iteration sequential fit under
    ``torch.profiler``."""
    msa = max(msas, key=lambda m: m.num_seqs * m.seqs_len)
    l, q = msa.seqs_len, msa.q
    codes = torch.from_numpy(msa.data).to(dev)
    w = family._weights_of(codes, 0.8, q)
    lam = float(np.float32(0.2 * (l - 1)))
    return busy_text(lambda: family._fit_one(codes, w, lam, lam, l, q, max_iterations=20),
                     f"the largest family's sequential fit ({msa.num_seqs} x {l}, 20 "
                     f"iterations)")


def lockstep_busy(msas, dev):
    """The lock-step fit of the bucket with the most padded work (lanes x
    Nb x (Lb q)^2), 20 iterations, under ``torch.profiler``."""
    groups = family.bucket_families(msas)
    idxs = max(groups.values(), key=lambda ix: len(ix) * max(msas[i].num_seqs for i in ix)
               * max(msas[i].seqs_len for i in ix) ** 2)
    q = msas[idxs[0]].q
    codes = [torch.from_numpy(msas[i].data.astype(np.int8)).to(dev) for i in idxs]
    ws = [family._weights_of(c, 0.8, q) for c in codes]
    lam = np.asarray([0.2 * (msas[i].seqs_len - 1) for i in idxs], np.float32)
    out = {}

    def fit():
        out["states"], out["run"] = family._fit_lockstep(codes, ws, lam, lam, q,
                                                         max_iterations=20)

    text = busy_text(fit, f"the largest bucket's lock-step fit ({len(idxs)} lanes at "
                          f"{(max(c.shape[0] for c in codes), max(c.shape[1] for c in codes))}, "
                          f"20 iterations)")
    run = out["run"]
    return f"{text}, {run.host_syncs} host syncs for {sum(s.k for s in out['states'])} " \
           f"family-iterations"


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


def rank_against(runs, reference, msas, what):
    """Every family's scores of each run at the rank bar against the
    reference's; returns the worst Spearman and top-20 overlap."""
    worst = (1.0, 1.0)
    for name, scores in runs.items():
        for k, (m, a, b) in enumerate(zip(msas, scores, reference)):
            rho, top = spearman(a, b, m.seqs_len), top_k_overlap(a, b, 20)
            check(rho >= 0.98 and top >= 0.9, f"{what} {name} family {k}: spearman "
                  f"{rho:.4f}, top-20 overlap {top:.2f}")
            worst = (min(worst[0], rho), min(worst[1], top))
    return worst


def phase_families(tmp, dev, smi):
    """``compute_fn_batch --apc`` through both CLIs: the JAX package's RNA
    sweep on the card and on the CPU, bucketed and (plm) ``--no_bucket``,
    against the sequential per-family loop; then planted protein
    families."""
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
    flat_gpu = run_batch(tmp, "plmdca", "rna", files, "cuda",
                         ["--max_iterations", "20", "--no_bucket"])
    for name, run in (("RNA plm batch", plm_gpu), ("RNA plm --no_bucket batch", flat_gpu)):
        check(run[2] == {"identity_counts": nf, "weighted_gram": 0},
              f"{name} launches {run[2]}, expected identity_counts {nf}")
    check(len(flat_gpu[0].batches) == 1 and flat_gpu[0].batches[0].lanes == nf,
          f"RNA --no_bucket ran {len(flat_gpu[0].batches)} lock-step batches, expected one of {nf}")
    check(mf_gpu[2] == {"identity_counts": nf, "weighted_gram": nf},
          f"RNA mean-field batch launches {mf_gpu[2]}, expected {nf} of each")
    check(torch.equal(family.family_sequence_weights(batch, device=dev).cpu(),
                      family.family_sequence_weights(batch, device="cpu")),
          "RNA sweep: family weights differ between the card and the CPU")
    worst = {}
    for cli in ("plmdca", "mfdca"):
        worst[cli] = rank_against({"cpu vs cuda": runs["cpu"][cli][4]}, runs["cuda"][cli][4],
                                  batch.msas, f"RNA {cli} batch")
    seq_scores, seq_text = sequential_fits(batch.msas, dev, 20)
    worst["seq"] = rank_against({"bucketed": plm_gpu[4], "--no_bucket": flat_gpu[4]},
                                seq_scores, batch.msas, "RNA lock-step against sequential")
    busy = family_busy(batch.msas, dev)
    lbusy = lockstep_busy(batch.msas, dev)
    print(f"phase 14 (a) [{smi}] RNA sweep, {nf} families q 5: on every family identity_counts "
          f"equal to plain, weighted_gram within (rtol, atol) {GRAM_TOL[torch.float32]} of plain "
          f"(max abs err {errs[0][1]:.3e}); weights equal on the card and the CPU; "
          f"plm cuda bucketed: {fits_text(plm_gpu[0], plm_gpu[1])}, peak {plm_gpu[3]:.2f} GiB; "
          f"plm cuda --no_bucket: {fits_text(flat_gpu[0], flat_gpu[1])}, peak "
          f"{flat_gpu[3]:.2f} GiB; plm cuda sequential (family._fit_one): {seq_text}; every "
          f"family's lock-step scores (bucketed and --no_bucket) against its sequential ones: "
          f"worst spearman {worst['seq'][0]:.4f} top-20 {worst['seq'][1]:.2f}; plm cpu bucketed: "
          f"{fits_text(runs['cpu']['plmdca'][0], runs['cpu']['plmdca'][1])}; worst family cpu vs "
          f"cuda plm spearman {worst['plmdca'][0]:.4f} top-20 {worst['plmdca'][1]:.2f}, mean-field "
          f"{worst['mfdca'][0]:.4f} / {worst['mfdca'][1]:.2f}; mean-field CLI wall cuda "
          f"{mf_gpu[1]:.3f} s cpu {runs['cpu']['mfdca'][1]:.3f} s; {busy}; {lbusy}; kernel "
          f"launches plm {plm_gpu[2]}, --no_bucket {flat_gpu[2]}, mean-field {mf_gpu[2]}",
          flush=True)

    sweep = protein_family_sweep()
    files = write_sweep(tmp, "protein_sweep", [c for c, _ in sweep], alphabets.PROTEIN)
    nf = len(files)
    prot = [plm.read_msa(f, "protein") for f in files]
    errs.append(family_kernel_checks(prot, dev, "protein sweep"))
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
    seq_scores, seq_text = sequential_fits(prot, dev, 100)
    worst_p = rank_against({"bucketed": plm_run[4]}, seq_scores, prot,
                           "protein lock-step against sequential")
    shapes = [c.shape for c, _ in sweep]
    big = max(plm_run[0].batches, key=lambda b: b.lanes * b.shape[0] * b.shape[1] ** 2)
    est = big.lanes * family.lockstep_lane_bytes(*big.shape, 21) / 2**30
    print(f"phase 14 (b) [{smi}] protein sweep, {nf} planted families q 21, N "
          f"{min(n for n, _ in shapes)}-{max(n for n, _ in shapes)}, L "
          f"{min(l for _, l in shapes)}-{max(l for _, l in shapes)}: on every family "
          f"identity_counts equal to plain, weighted_gram within GRAM_TOL (max abs err "
          f"{errs[1][1]:.3e}); planted recovery min plm {min(shares['plm']):.2f} mean-field "
          f"{min(shares['mean-field']):.2f} (top {PLANTED_TOP}); plm bucketed: "
          f"{fits_text(plm_run[0], plm_run[1])}, peak {plm_run[3]:.2f} GiB (the largest batch, "
          f"{big.lanes} x {big.shape}, counts {est:.2f} GiB against LOCKSTEP_MAX_BYTES "
          f"{family.LOCKSTEP_MAX_BYTES / 2**30:.0f} GiB); plm sequential (family._fit_one): "
          f"{seq_text}; every family's lock-step scores against its sequential ones: worst "
          f"spearman {worst_p[0]:.4f} top-20 {worst_p[1]:.2f}; mean-field CLI wall {mf_run[1]:.3f} s, "
          f"peak {mf_run[3]:.2f} GiB; kernel launches plm {plm_run[2]}, mean-field {mf_run[2]}",
          flush=True)
    ident = sum(r[2]["identity_counts"] for r in (plm_gpu, flat_gpu, mf_gpu, plm_run, mf_run))
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
        "--device", cli_device("cuda"), "--output_dir", out,
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
            "compute_fn", "protein", fa, "--apc", "--refseq_file", rf,
            "--device", cli_device(device),
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


# ------------------------------------------------------------- phase 19
# the CPU tests' tolerances (tests/test_torch_plm_bf16.py)
BF16_LOSS_RTOL, BF16_GRAD_REL_L2 = 1e-5, 1e-4
CARD_VS_CPU_ROWS = 512  # phase 3's first rows for (d): the CPU evaluates at the real width


def rank_bar(scores, ref, l, what):
    """FN-APC Spearman and top-20 overlap against ``ref`` at the JAX
    package's bar; returns the line's text."""
    rho, top = spearman(scores, ref, l), top_k_overlap(scores, ref, 20)
    check(rho >= 0.98 and top >= 0.9, f"{what}: spearman {rho:.4f}, top-20 overlap {top:.2f}")
    return f"spearman {rho:.4f} top-20 overlap {top:.2f}"


def product_profile(x, w, ct, q, l, mm_bf16, reps=10):
    """The forward (``x @ W``) and backward (``x^T @ ct``) logits products
    as the fused fit calls them (the bfloat16 casts of ``W`` and ``ct``
    included): ms per call by CUDA events and TFLOP/s from it; under
    torch.profiler, the longest kernel's name and the GEMM kernels' share
    of the device time it recorded.  The profiler on the card's machine
    drops kernel records at the end of some sessions
    (``scripts/torch_profiler_drops.py``), so its times are not used."""
    flops = 2.0 * x.shape[0] * (l * q) * (q * l)
    out = {}
    for name, fn in (("forward", lambda: plm._logits_mm(x, w, q, l, mm_bf16)),
                     ("backward", lambda: plm._mm_b(x, ct, mm_bf16=mm_bf16))):
        ms = cuda_ms(fn, reps)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_time_total > 0]
        total = sum(e.device_time_total for e in events)
        gemm = sum(e.device_time_total for e in events if is_gemm(e.key))
        top = max(events, key=lambda e: e.device_time_total).key[:48] if events else None
        out[name] = dict(ms=ms, tflops=flops / (ms * 1e-3) / 1e12, kernel=top,
                         gemm_share=gemm / total if total else None)
    return out


def profile_text(prof):
    def one(k, v):
        if v["kernel"] is None:
            return f"{k} {v['ms']:.3f} ms, {v['tflops']:.1f} TFLOP/s (no kernel record captured)"
        return (f"{k} {v['ms']:.3f} ms, {v['tflops']:.1f} TFLOP/s (GEMM "
                f"{100 * v['gemm_share']:.1f}% of the recorded device time, {v['kernel']})")
    return "; ".join(one(k, v) for k, v in prof.items())


def phase_bf16_cli(tmp, smi, main_fa, inst_main, scores_main):
    """(a) ``plmdca compute_fn --apc --precision bfloat16`` on phase 3's
    file on card 0 against phase 3's float32 file, and both products in
    float32 and bfloat16 at phase 3's fitted theta (:func:`product_profile`)."""
    l, q = inst_main.sequences_len, inst_main.num_site_states
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    inst, (_, scores) = run_cli("protein", main_fa, os.path.join(tmp, "p19a"), "cuda",
                                ["--precision", "bfloat16"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(inst.mm_bf16, "(a): the engine does not run bfloat16 products")
    bar = rank_bar(scores, scores_main, l, "phase 19 (a) bfloat16 against phase 3")
    res, fit_s = inst.fit_result, inst.timers.elapsed("fit")
    ref, ref_s = inst_main.fit_result, inst_main.timers.elapsed("fit")
    # the two products at phase 3's shapes, its one-hot and its fitted theta
    theta = ref.x
    codes = torch.from_numpy(inst_main.msa.data).to(theta.device)
    x, maskq = plm._prep_msa(codes, l, q)
    w = plm._expand_w4(theta[l * q :], l, q)
    logits = plm._logits_mm(x, w, q, l).add_(theta[: l * q].reshape(l, q).T[None])
    ct, _ = plm._ct_gh(logits, maskq, inst_main.compute_seqs_weight())
    del logits
    profs = {"float32": product_profile(x, w, ct, q, l, False),
             "bfloat16": product_profile(x.to(torch.bfloat16), w, ct, q, l, True)}
    del x, maskq, w, ct
    torch.cuda.empty_cache()
    per_it = 1e3 * fit_s / max(res.num_iters, 1)
    ref_it = 1e3 * ref_s / max(ref.num_iters, 1)
    print(f"phase 19 (a) [{smi}] plmdca compute_fn --apc --precision bfloat16 N="
          f"{inst.num_sequences} L={l} q={q}: FN-APC against phase 3's float32 file {bar}; "
          f"{res.num_iters} iterations, {res.n_evals} evaluations, {per_it:.2f} ms/iteration, "
          f"host syncs/iteration {res.host_syncs / max(res.num_iters, 1):.2f}, discarded trials "
          f"{res.discarded_trials}, fit {fit_s:.3f} s, "
          f"peak memory {peak:.2f} GiB; phase 3 (float32): {ref.num_iters} iterations, "
          f"{ref_it:.2f} ms/iteration, host syncs/iteration "
          f"{ref.host_syncs / max(ref.num_iters, 1):.2f}; the products at phase 3's theta "
          f"(CUDA events; kernels from torch.profiler), float32: "
          f"{profile_text(profs['float32'])}; bfloat16: "
          f"{profile_text(profs['bfloat16'])}", flush=True)
    return scores


def phase_bf16_deep(dev, smi, deep_codes, deep_s_eval):
    """(c) ``PlmDCA(precision="bfloat16")`` streamed at 10^5 x 1000, q 21
    (phase 12's codes), two iterations, and one evaluation under
    torch.profiler, beside phase 12's float32 s/evaluation."""
    n, l, q = DEEP_SHAPE
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    inst = plm.PlmDCA(MSA(data=deep_codes, alphabet=alphabets.PROTEIN), "protein",
                      max_iterations=2, device=dev.type, precision="bfloat16")
    scores = inst.compute_sorted_FN_APC()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(inst.seq_block == 12782 and inst.mm_bf16, "(c): not the streamed bfloat16 route")
    check(len(scores) == l * (l - 1) // 2 and bool(np.isfinite([s for _, s in scores]).all()),
          "(c): scores missing or not finite")
    res, fit_s = inst.fit_result, inst.timers.elapsed("fit")
    msa = torch.from_numpy(deep_codes).to(dev)
    wall_ms, dev_ms, mm_ms, top = streamed_eval_profile(inst, msa, l, q, mm_bf16=True)
    s_eval = fit_s / res.n_evals
    print(f"phase 19 (c) [{smi}] PlmDCA(precision='bfloat16') streamed N={n} L={l} q={q}, "
          f"seq_block {inst.seq_block}: {fit_text(res, fit_s)}; {s_eval:.4f} s/evaluation "
          f"against phase 12's float32 {deep_s_eval:.4f} (x{deep_s_eval / s_eval:.2f}); one "
          f"evaluation under torch.profiler: wall {wall_ms:.1f} ms, device {dev_ms:.1f} ms, the "
          f"products' kernels {mm_ms:.1f} ms (longest: {top}); peak memory {peak:.2f} GiB",
          flush=True)


def phase_card_vs_cpu(smi, inst_main):
    """(d) one bfloat16 evaluation on the card against the port's CPU
    route, at phase 3's fitted theta on its first CARD_VS_CPU_ROWS rows,
    with the CPU tests' tolerances."""
    l, q = inst_main.sequences_len, inst_main.num_site_states
    lam_h, lam_j = inst_main.lambda_h, inst_main.lambda_J
    theta = inst_main.fit_result.x
    codes = torch.from_numpy(inst_main.msa.data[:CARD_VS_CPU_ROWS])
    weights = inst_main.compute_seqs_weight()[:CARD_VS_CPU_ROWS].cpu()
    got = {}
    for dev_name in ("cuda", "cpu"):
        d = torch.device(dev_name)
        f, g = plm.plm_loss_and_grad_chunked(theta.to(d), codes.to(d), weights.to(d), lam_h,
                                             lam_j, l, q, CARD_VS_CPU_ROWS, mm_bf16=True)
        got[dev_name] = (float(f), g.cpu().double())
    bf_card, bf_cpu = got["cuda"], got["cpu"]
    bf_loss = abs(bf_card[0] - bf_cpu[0]) / abs(bf_cpu[0])
    bf_grad = float((bf_card[1] - bf_cpu[1]).norm() / bf_cpu[1].norm())
    check(bf_loss <= BF16_LOSS_RTOL and bf_grad <= BF16_GRAD_REL_L2,
          f"(d) bfloat16 card vs CPU: loss {bf_loss:.3e}, gradient relative L2 {bf_grad:.3e}")
    print(f"phase 19 (d) [{smi}] card against the CPU route at phase 3's theta, N="
          f"{CARD_VS_CPU_ROWS} L={l} q={q}: bfloat16 evaluation loss relative {bf_loss:.3e} "
          f"(<= {BF16_LOSS_RTOL:g}), gradient relative L2 {bf_grad:.3e} (<= {BF16_GRAD_REL_L2:g})",
          flush=True)


# ------------------------------------------------------------- phase 16
WORKER_TIMEOUT_S = 300  # each rank process of phase 16 (b)-(d)
GROUP_TIMEOUT = timedelta(seconds=120)  # a collective that waits longer fails the run
DEEP_THETA_TOL = (2e-3, 2e-3)  # (rtol, atol): two float32 sums over the blocks in other orders


def digest(t: torch.Tensor) -> str:
    """blake2b of a tensor's bytes: equal digests are equal bits."""
    a = np.ascontiguousarray(t.detach().cpu().numpy())
    return hashlib.blake2b(a.view(np.uint8), digest_size=16).hexdigest()


def collective_text(collectives, per: int, what: str) -> str:
    """Each collective's count and milliseconds (timed by the mesh) per
    ``what``, with its size, and the seconds of all of them."""
    each = ", ".join(f"{name} {c / per:.2f}x {1e3 * t / per:.2f} ms ({numel / max(c, 1):.3g} "
                     f"elements)" for name, (c, numel, t, _) in sorted(collectives.items()))
    total = sum(rec[2] for rec in collectives.values())
    return f"{each} per {what} (collectives {total:.3f} s in all)"


def collective_list(collectives) -> str:
    """Each collective's calls, elements and seconds in all."""
    return ", ".join(f"{name} {c}x {numel:.3g} elements {t:.3f} s"
                     for name, (c, numel, t, _) in sorted(collectives.items()))


def phase_mesh_one_rank(dev, tmp, main_fa, inst_main, mf_ref):
    """(a) ``PlmDCA`` and ``MeanFieldDCA`` over a one-rank NCCL group on
    phase 3's and phase 6's files: a one-rank all-reduce changes no value
    and the rank's tile share is the whole list, so the weights, theta and
    FN-APC must equal those phases' bit for bit.  Returns the launches."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    init_distributed("nccl", store=dist.FileStore(os.path.join(tmp, "nccl_store"), 1), rank=0,
                     world_size=1, timeout=GROUP_TIMEOUT, device_id=torch.device("cuda", index))
    try:
        mesh = make_mesh(device=dev)
        mesh.timed = True
        torch.cuda.empty_cache()
        reset_launches()
        inst = plm.PlmDCA(main_fa, "protein", max_iterations=100, device=dev, mesh=mesh)
        scores = inst.compute_sorted_FN_APC()
        res = inst.fit_result
        w_equal = torch.equal(inst.compute_seqs_weight(), inst_main.compute_seqs_weight())
        theta, theta_main = inst.fit_result.x, inst_main.fit_result.x
        diff = float((theta - theta_main).abs().max())
        main_scores = inst_main.compute_sorted_FN_APC()
        s_diff = max(abs(a - b) for a, b in zip(dict(scores).values(),
                                                (dict(main_scores)[k] for k in dict(scores))))
        check(w_equal and diff == 0 and scores == main_scores,
              f"one-rank plm mesh against phase 3: weights equal {w_equal}, theta max |diff| "
              f"{diff:.3e}, FN-APC max |diff| {s_diff:.3e} (the one-rank sums must change "
              "nothing)")
        plm_text = (f"plm {res.num_iters} iterations, {res.n_evals} evaluations, fit "
                    f"{inst.timers.elapsed('fit'):.3f} s; "
                    + collective_text(mesh.collectives, max(res.num_iters, 1), "iteration"))
        plm_launches = dict(ident=ck.identity_counts.launches, gram=ck.weighted_gram.launches)
        mesh.collectives.clear()
        reset_launches()
        mf = MeanFieldDCA(mf_ref["fa"], "protein", device=dev, mesh=mesh)
        mf_scores = mf.compute_sorted_FN_APC()
        w_equal = torch.equal(mf.get_sequences_weight().cpu(), mf_ref["weights"])
        c_equal = digest(mf.compute_couplings()) == mf_ref["couplings"]
        s_equal = mf_scores == mf_ref["scores"]
        check(w_equal and c_equal and s_equal,
              f"one-rank mean-field mesh against phase 6: weights equal {w_equal}, couplings "
              f"equal {c_equal}, FN-APC equal {s_equal}")
        mf_text = (f"mean-field gram {mf.timers.elapsed('gram'):.3f} s, "
                   + collective_text(mesh.collectives, 1, "run"))
        del mf
    finally:
        dist.destroy_process_group()
    launches = dict(ident=plm_launches["ident"] + ck.identity_counts.launches,
                    gram=plm_launches["gram"] + ck.weighted_gram.launches)
    print(f"phase 16 (a) one-rank NCCL group: weights, theta and FN-APC equal to phase 3's "
          f"bit for bit, weights, couplings and FN-APC equal to phase 6's; {plm_text}; "
          f"{mf_text}; kernel launches {launches}", flush=True)
    return launches


def phase16_worker(spec_path: str, rank: int) -> int:
    """One rank of phase 16 (b)-(d): both CLIs with ``--mesh auto`` on the
    spec's files, then (on one card) the deep streamed fit; prints one
    ``PHASE16 {json}`` line."""
    with open(spec_path) as fh:
        spec = json.load(fh)
    if spec.get("grid"):
        return phase20_worker(spec, rank)
    set_precision()
    dev = torch.device("cuda", spec["cards"][rank])
    torch.cuda.set_device(dev)
    backend = spec["backend"]
    init_distributed(backend, store=dist.FileStore(spec["store"], 2), rank=rank, world_size=2,
                     timeout=GROUP_TIMEOUT,
                     **({"device_id": dev} if backend == "nccl" else {}))
    meshes = []

    def timed_launch(mesh, device, _real=plmdca_main.launch_mesh):
        m, d = _real(mesh, device)
        m.timed = True  # the collectives' own seconds, the device synchronised around each
        meshes.append(m)
        return m, d

    plmdca_main.launch_mesh = mfdca_main.launch_mesh = timed_launch
    report = {"rank": rank}
    cases = [("plm", plmdca_main.run_plm_dca, spec["plm_fa"], []),
             ("mf", mfdca_main.run_meanfield_dca, spec["mf_fa"], [])]
    cases += [(name, plmdca_main.run_plm_dca, spec["plm_fa"], flags)
              for name, flags in spec.get("flag_cases", [])]
    for name, cli, fa, flags in cases:
        is_plm = name.startswith("plm")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        argv = ["compute_fn", "protein", fa, "--apc", "--mesh", "auto", "--device", str(dev),
                "--output_dir", spec[f"{name}_out"]] + flags
        t0 = time.perf_counter()
        inst = cli(argv + (["--max_iterations", "100"] if is_plm else []))
        wall = time.perf_counter() - t0
        mesh = meshes[-1]
        rec = dict(wall=wall, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   collectives=mesh.collectives, timers={k: inst.timers.elapsed(k) for k in (
                       ("weights", "fit", "score") if is_plm else
                       ("weights", "gram", "corr", "inverse", "score"))},
                   ident=ck.identity_counts.launches, gram=ck.weighted_gram.launches)
        if is_plm:
            res = inst.fit_result
            rec.update(iters=res.num_iters, n_evals=res.n_evals, host_syncs=res.host_syncs,
                       theta=digest(res.x), weights=inst.compute_seqs_weight().cpu().tolist())
        else:
            rec.update(theta=digest(inst.compute_couplings()),
                       weights=inst.get_sequences_weight().cpu().tolist())
        report[name] = rec
        del inst
    if spec.get("deep_codes"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        mesh = make_mesh(device=dev)
        mesh.timed = True
        codes = np.load(spec["deep_codes"])
        t0 = time.perf_counter()
        inst = plm.PlmDCA(MSA(data=codes, alphabet=alphabets.PROTEIN), "protein",
                          max_iterations=2, device=dev, mesh=mesh, seq_block=spec["seq_block"])
        inst._theta()  # the fit, without a host copy of theta
        res = inst.fit_result
        wall = time.perf_counter() - t0
        ref = torch.from_numpy(np.load(spec["deep_theta"])).to(dev)
        diff = (res.x - ref).abs_()
        rtol, atol = DEEP_THETA_TOL
        w_ref = torch.from_numpy(np.load(spec["deep_weights"]))
        report["deep"] = dict(
            wall=wall, iters=res.num_iters, n_evals=res.n_evals, host_syncs=res.host_syncs,
            timers={k: inst.timers.elapsed(k) for k in ("weights", "fit")},
            collectives=mesh.collectives, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            theta=digest(res.x), max_abs=float(diff.max()),
            within=bool((diff <= atol + rtol * ref.abs()).all()),
            weights_equal=torch.equal(inst.compute_seqs_weight().cpu(), w_ref),
            ident=ck.identity_counts.launches)
    print("PHASE16 " + json.dumps(report), flush=True)
    dist.destroy_process_group()
    return 0


def spawn_ranks(spec: dict, tmp: str, tag: str, prefix: str = "PHASE16 "):
    """Run the two rank processes of one phase 16 (or 20) case; their
    reports (the line each prints after ``prefix``)."""
    spec_path = os.path.join(tmp, f"phase16_{tag}.json")
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--phase16-worker",
                               spec_path, str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:  # a rank that outlived its limit is stopped, not left running
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith(prefix)]
        check(p.returncode == 0 and len(lines) == 1,
              f"{prefix.strip().lower()} ({tag}) rank {r} failed (exit {p.returncode}):\n"
              f"{out[-4000:]}")
        reports.append(json.loads(lines[0][len(prefix):]))
    return reports


def check_cli_ranks(reps, name, out_dir, ref_weights, ref_scores, l):
    """Both ranks' weights and theta, rank 0's one file against the
    one-process run's scores; returns the line's text."""
    r0, r1 = reps[0][name], reps[1][name]
    check(r0["theta"] == r1["theta"], f"{name}: the two ranks' parameters differ")
    w = torch.tensor(r0["weights"], dtype=torch.float32)
    check(torch.equal(w, ref_weights) and r0["weights"] == r1["weights"],
          f"{name}: the ranks' weights differ from the one-process run's")
    files = os.listdir(out_dir)
    check(len(files) == 1, f"{name}: {len(files)} output files, expected one (rank 0's)")
    _, scores = read_scores(os.path.join(out_dir, files[0]))
    rho, top = spearman(scores, ref_scores, l), top_k_overlap(scores, ref_scores, 20)
    check(rho >= 0.98 and top >= 0.9,
          f"{name}: two ranks against one process: spearman {rho:.4f}, top-20 {top:.2f}")
    parts = [f"{name}: weights equal, theta equal on both ranks, one file; spearman {rho:.4f} "
             f"top-20 {top:.2f} against one process"]
    for rep in reps:
        rec = rep[name]
        coll_s = sum(c[2] for c in rec["collectives"].values())
        if name.startswith("plm"):
            it = max(rec["iters"], 1)
            fit = rec["timers"]["fit"]
            parts.append(
                f"rank {rep['rank']}: {rec['iters']} iterations, {1e3 * fit / it:.2f} ms/iteration, "
                f"host syncs/iteration {rec['host_syncs'] / it:.2f}, "
                + collective_text(rec["collectives"], it, "iteration")
                + f", collectives {100 * coll_s / max(fit + rec['timers']['weights'], 1e-9):.1f}% "
                f"of weights + fit, peak {rec['peak_gib']:.2f} GiB, wall {rec['wall']:.2f} s")
        else:
            t = rec["timers"]
            parts.append(
                f"rank {rep['rank']}: " + " ".join(f"{k} {v:.3f} s" for k, v in t.items())
                + "; " + collective_text(rec["collectives"], 1, "run")
                + f", collectives {100 * coll_s / max(sum(t.values()), 1e-9):.1f}% of the "
                f"stages, peak {rec['peak_gib']:.2f} GiB, wall {rec['wall']:.2f} s")
    return "; ".join(parts)


FLAG_CASES = [("plm_bf16", ["--precision", "bfloat16"])]


def phase_mesh_two_ranks(tmp, smi, main_fa, main_scores, inst_main, mf_ref, deep_block,
                         flag_scores):
    """(b) two ranks on card 0 under gloo through both CLIs, and the plm
    CLI with ``--precision bfloat16`` against its one-process run of
    phase 19 (``flag_scores``), (c) the
    deep streamed fit on the same ranks, (d) on two cards under NCCL when
    the machine has them.  Returns the launches of (b)-(d) and (b)'s
    ranks' plm CLI walls."""
    cards = torch.cuda.device_count()
    main_w = inst_main.compute_seqs_weight().cpu()
    plm_l = inst_main.sequences_len
    mf_l = MF_SHAPE[1]
    cases = [("b", "gloo", [0, 0])] + ([("d", "nccl", [0, 1])] if cards >= 2 else [])
    launches = dict(ident=0, gram=0)
    walls_b = []
    for tag, backend, card_list in cases:
        spec = dict(store=os.path.join(tmp, f"store_{tag}"), backend=backend, cards=card_list,
                    plm_fa=main_fa, mf_fa=mf_ref["fa"],
                    plm_out=os.path.join(tmp, f"p16{tag}_plm"),
                    mf_out=os.path.join(tmp, f"p16{tag}_mf"))
        if tag == "b":  # the flag cases and (c) ride on (b)'s ranks
            spec["flag_cases"] = FLAG_CASES
            for name, _ in FLAG_CASES:
                spec[f"{name}_out"] = os.path.join(tmp, f"p16{tag}_{name}")
            spec.update(deep_codes=os.path.join(tmp, "deep_codes.npy"),
                        deep_theta=os.path.join(tmp, "deep_theta.npy"),
                        deep_weights=os.path.join(tmp, "deep_weights.npy"),
                        seq_block=deep_block)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        reps = spawn_ranks(spec, tmp, tag)
        wall = time.perf_counter() - t0
        texts = [check_cli_ranks(reps, "plm", spec["plm_out"], main_w, main_scores, plm_l),
                 check_cli_ranks(reps, "mf", spec["mf_out"], mf_ref["weights"],
                                 mf_ref["file_scores"], mf_l)]
        texts += [check_cli_ranks(reps, name, spec[f"{name}_out"], main_w, flag_scores[name],
                                  plm_l) for name, _ in spec.get("flag_cases", [])]
        for rep in reps:
            runs = [v for k, v in rep.items() if k != "rank"]
            launches["ident"] += sum(r["ident"] for r in runs)
            launches["gram"] += sum(r.get("gram", 0) for r in runs)
        where = "two ranks on card 0, gloo" if tag == "b" else "two cards, NCCL"
        print(f"phase 16 ({tag}) [{smi}] {where}: " + " | ".join(texts)
              + f"; both CLIs' ranks in {wall:.2f} s", flush=True)
        if tag == "b":
            walls_b = [rep["plm"]["wall"] for rep in reps]
            d0, d1 = reps[0]["deep"], reps[1]["deep"]
            check(d0["theta"] == d1["theta"], "deep: the two ranks' theta differ")
            check(d0["weights_equal"] and d1["weights_equal"], "deep: weights differ from phase 12's")
            check(d0["within"] and d1["within"],
                  f"deep: theta after {d0['iters']} iterations off phase 12's: max |diff| "
                  f"{d0['max_abs']:.3e} (rtol, atol {DEEP_THETA_TOL})")
            per = max(d0["n_evals"], 1)
            rank_parts = [
                f"rank {rep['rank']}: weights {rep['deep']['timers']['weights']:.3f} s, fit "
                f"{rep['deep']['timers']['fit']:.3f} s, {rep['deep']['timers']['fit'] / per:.3f} "
                f"s/evaluation, " + collective_text(rep["deep"]["collectives"], per, "evaluation")
                + f", peak {rep['deep']['peak_gib']:.2f} GiB" for rep in reps]
            print(f"phase 16 (c) [{smi}] deep streamed fit N={DEEP_SHAPE[0]} L={DEEP_SHAPE[1]} "
                  f"q={DEEP_SHAPE[2]} over two gloo ranks on card 0, seq_block {deep_block}: "
                  f"{d0['iters']} iterations, {d0['n_evals']} evaluations; theta equal on both "
                  f"ranks, within (rtol, atol) {DEEP_THETA_TOL} of phase 12's (max |diff| "
                  f"{d0['max_abs']:.3e}); weights equal to phase 12's; " + "; ".join(rank_parts),
                  flush=True)
    if cards < 2:
        print(f"phase 16 (d) did not run: this machine has {cards} card(s); two ranks on two "
              "cards under NCCL need two", flush=True)
    return launches, walls_b


def phase_spawned_ranks(tmp, smi, main_fa, wall_b):
    """(e) ``spawn_cli``, the CLIs' one-process launch over every card,
    with two gloo ranks on card 0 for ``plmdca compute_fn --apc --mesh
    auto`` on (b)'s argv: the file must equal (b)'s byte for byte; the
    wall beside (b)'s ranks' CLI walls is the launch's own cost."""
    out = os.path.join(tmp, "p16e_plm")
    argv = ["compute_fn", "protein", main_fa, "--apc", "--mesh", "auto", "--device", "cuda:0",
            "--output_dir", out, "--max_iterations", "100"]
    t0 = time.perf_counter()
    code = spawn_cli(plmdca_main.run_plm_dca, argv, 2, "cuda:0")
    wall = time.perf_counter() - t0
    check(code == 0, f"phase 16 (e): a spawned rank failed (exit {code})")
    files = os.listdir(out)
    check(len(files) == 1, f"phase 16 (e): {len(files)} output files, expected rank 0's one")
    with open(os.path.join(out, files[0]), "rb") as fe, \
            open(os.path.join(tmp, "p16b_plm", files[0]), "rb") as fb:
        same = fe.read() == fb.read()
    check(same, "phase 16 (e): the spawned ranks' file differs from (b)'s")
    print(f"phase 16 (e) [{smi}] spawn_cli(run_plm_dca, 2 ranks, 'cuda:0'), gloo on card 0: the "
          f"file equals (b)'s byte for byte; wall {wall:.2f} s (two processes started, "
          f"imports, group, CLI) against (b)'s ranks' plm CLI walls "
          f"{' / '.join(f'{w:.2f}' for w in wall_b)} s: the launch costs "
          f"{wall - max(wall_b):.2f} s", flush=True)


# ------------------------------------------------------------- phase 20
SOLVE_TOL = 1e-3  # the f32 factors and inverses on phase 6's C, relative to the largest entry
COUPLINGS_TOL = 1e-3  # the model-sharded couplings against phase 6's, relative to max |J|
DRYRUN_TIMEOUT_S = 300


class SolveTimers(StageTimers):
    """Stage timers that keep the peak device memory over the stages of
    the solve (``cholesky`` to ``syrk``, C's row slab resident)."""

    solve_peak = 0

    @contextlib.contextmanager
    def stage(self, name):
        if name == "cholesky":
            torch.cuda.reset_peak_memory_stats()
        with StageTimers.stage(self, name):
            yield
        if name == "syrk":
            self.solve_peak = torch.cuda.max_memory_allocated()


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def phase_solve_one_card(dev, smi, mf_ref):
    """(a) The blocked Cholesky, the triangular inverse and
    ``spd_inverse(chol_block=2048)`` on phase 6's C (D = 20000), one
    process on one card, against ``cholesky_ex``, ``solve_triangular`` and
    the engine's ``spd_inverse``; returns the engine solve's peak memory
    (C resident)."""
    inst = MeanFieldDCA(mf_ref["fa"], "protein", device=dev)
    c = inst.construct_corr_mat()
    del inst
    d = c.shape[0]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    inv_e, info_e = linalg.spd_inverse(c)
    torch.cuda.synchronize()
    peak_engine = torch.cuda.max_memory_allocated()
    chol_ref, info_ref = torch.linalg.cholesky_ex(c)
    fac, info_b = linalg.cholesky_blocked(c, 2048)
    e_chol = rel_err(fac, chol_ref)
    del fac
    eye = torch.eye(d, dtype=c.dtype, device=dev)
    w_ref = torch.linalg.solve_triangular(chol_ref, eye, upper=False)
    del eye
    w = linalg.tri_inv_lower(chol_ref)
    e_tri = rel_err(w, w_ref)
    del w, w_ref
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    inv_b, info_s = linalg.spd_inverse(c, chol_block=2048)
    torch.cuda.synchronize()
    peak_blocked = torch.cuda.max_memory_allocated()
    e_inv = rel_err(inv_b, inv_e)
    del inv_b, inv_e
    infos = [int(x) for x in (info_e, info_ref, info_b, info_s)]
    check(infos == [0, 0, 0, 0], f"phase 20 (a): a factorisation failed, info {infos}")
    check(max(e_chol, e_tri, e_inv) <= SOLVE_TOL,
          f"phase 20 (a): relative errors factor {e_chol:.3e}, triangular inverse {e_tri:.3e}, "
          f"inverse {e_inv:.3e} above {SOLVE_TOL}")
    ms = {name: cuda_ms(fn, 1) for name, fn in (
        ("cholesky_ex", lambda: torch.linalg.cholesky_ex(c)),
        ("cholesky_blocked", lambda: linalg.cholesky_blocked(c, 2048)),
        ("solve_triangular", lambda: torch.linalg.solve_triangular(
            chol_ref, torch.eye(d, dtype=c.dtype, device=dev), upper=False)),
        ("tri_inv_lower", lambda: linalg.tri_inv_lower(chol_ref)),
        ("engine spd_inverse", lambda: linalg.spd_inverse(c)),
        ("spd_inverse(chol_block=2048)", lambda: linalg.spd_inverse(c, chol_block=2048)),
    )}
    del chol_ref, c
    torch.cuda.empty_cache()
    print(f"phase 20 (a) [{smi}] one card, phase 6's C (D={d}, float32): relative error "
          f"(max |diff| / max |ref|) cholesky_blocked {e_chol:.3e} against cholesky_ex, "
          f"tri_inv_lower {e_tri:.3e} against solve_triangular, spd_inverse(chol_block=2048) "
          f"{e_inv:.3e} against the engine's (<= {SOLVE_TOL}); ms (CUDA events, one call after "
          "one warm-up) " + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
          + f"; solve peak (C resident) engine {peak_engine / 2**30:.2f} GiB, blocked "
          f"{peak_blocked / 2**30:.2f} GiB", flush=True)
    return peak_engine


def phase20_worker(spec: dict, rank: int) -> int:
    """One rank of phase 20 (b): ``mfdca_sharded`` on phase 6's file over a
    1 x 2 grid, then the one-card engine on the same file (its couplings
    must be phase 6's bit for bit) to hold the rank's rows and the FN-APC
    ranking to; prints one ``PHASE20 {json}`` line."""
    set_precision()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    init_distributed("gloo", store=dist.FileStore(spec["store"], 2), rank=rank, world_size=2,
                     timeout=GROUP_TIMEOUT)
    mesh = make_mesh(1, 2, device=dev)
    mesh.timed = True
    msa = fasta.read_msa(spec["mf_fa"], "protein")
    l = msa.seqs_len
    codes, _, valid = shard_msa(mesh, msa.data)
    timers = SolveTimers()
    torch.cuda.empty_cache()
    reset_launches()
    t0 = time.perf_counter()
    fn, fn_apc, rows = mfdca_sharded(codes, biomolecule_q=msa.q, valid=valid, mesh=mesh,
                                     return_couplings=True, timers=timers)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    report = dict(rank=rank, model_rank=mesh.model_rank, wall=wall,
                  stages={k: timers.elapsed(k) for k in (
                      "weights", "gram", "corr", "cholesky", "tri_inv", "syrk", "score")},
                  solve_peak=timers.solve_peak, rows=[rows.start, rows.stop],
                  collectives={k: list(v) for k, v in mesh.collectives.items()},
                  ident=ck.identity_counts.launches, gram=ck.weighted_gram.launches)
    scores = score.sorted_scores(fn_apc, l)
    del fn, fn_apc
    ref = MeanFieldDCA(spec["mf_fa"], "protein", device=dev)
    cpl = ref.compute_couplings()
    report.update(same_as_phase6=digest(cpl) == spec["couplings"],
                  couplings_err=float((rows.rows - cpl[rows.start : rows.stop]).abs().max()
                                      / cpl.abs().max()))
    ref_scores = ref.compute_sorted_FN_APC()
    report.update(spearman=spearman(scores, ref_scores, l),
                  top20=top_k_overlap(scores, ref_scores, 20))
    print("PHASE20 " + json.dumps(report), flush=True)
    dist.destroy_process_group()
    return 0


def phase_grid_two_ranks(tmp, smi, mf_ref, one_card_peak):
    """(b) ``mfdca_sharded`` on phase 6's codes over two gloo ranks on card
    0 as a 1 x 2 grid: the rank bar against phase 6, the couplings' rows,
    each rank's solve peak beside the one-card engine's, the stages and the
    collectives.  Returns the ranks' kernel launches."""
    spec = dict(grid=[1, 2], store=os.path.join(tmp, "store_p20"), mf_fa=mf_ref["fa"],
                couplings=mf_ref["couplings"])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reps = spawn_ranks(spec, tmp, "b", prefix="PHASE20 ")
    wall = time.perf_counter() - t0
    parts = []
    for rep in reps:
        r = rep["rank"]
        check(rep["same_as_phase6"], f"phase 20 (b) rank {r}: the one-card reference's "
              "couplings differ from phase 6's")
        check(rep["spearman"] >= 0.98 and rep["top20"] >= 0.9,
              f"phase 20 (b) rank {r}: FN-APC against phase 6: spearman {rep['spearman']:.4f}, "
              f"top-20 {rep['top20']:.2f}")
        check(rep["couplings_err"] <= COUPLINGS_TOL,
              f"phase 20 (b) rank {r}: couplings rows {rep['couplings_err']:.3e} off phase 6's "
              f"(relative to max |J|; <= {COUPLINGS_TOL})")
        check(rep["solve_peak"] < one_card_peak,
              f"phase 20 (b) rank {r}: solve peak {rep['solve_peak'] / 2**30:.2f} GiB, not below "
              f"the one-card solve's {one_card_peak / 2**30:.2f} GiB")
        coll = collective_list(rep["collectives"])
        parts.append(
            f"rank {r} (model rank {rep['model_rank']}, rows {rep['rows'][0]}-{rep['rows'][1]}): "
            f"spearman {rep['spearman']:.4f} top-20 {rep['top20']:.2f} against phase 6, "
            f"couplings rows {rep['couplings_err']:.3e} of max |J|, solve peak "
            f"{rep['solve_peak'] / 2**30:.2f} GiB (one card {one_card_peak / 2**30:.2f}); "
            + " ".join(f"{k} {v:.3f} s" for k, v in rep["stages"].items())
            + f", wall {rep['wall']:.3f} s; collectives: {coll}")
    print(f"phase 20 (b) [{smi}] mfdca_sharded on phase 6's codes, a 1 x 2 grid of gloo ranks on "
          f"card 0 (the model-sharded solve, the blocked Cholesky at D=20000): "
          + " | ".join(parts) + f"; both ranks in {wall:.2f} s", flush=True)
    return dict(ident=sum(r["ident"] for r in reps), gram=sum(r["gram"] for r in reps))


def phase_dryrun(smi):
    """(c) ``python -m pydca_tpu_torch.dryrun --n 4 --device cuda:0``: four
    gloo ranks on card 0, a 2 x 2 grid, with the dryrun's three checks."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pydca_tpu_torch.dryrun", "--n", "4",
                           "--device", "cuda:0"], cwd=root, capture_output=True, text=True,
                          timeout=DRYRUN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("dryrun_multichip OK")]
    check(proc.returncode == 0 and len(lines) == 1,
          f"phase 20 (c): the dryrun failed (exit {proc.returncode}):\n{proc.stdout[-2000:]}"
          f"{proc.stderr[-4000:]}")
    check(lines[0].startswith("dryrun_multichip OK: mesh {'data': 2, 'model': 2}"),
          f"phase 20 (c): {lines[0]}")
    print(f"phase 20 (c) [{smi}] {lines[0]}; wall {wall:.2f} s (four processes)", flush=True)


# ------------------------------------------------------------- phases 17-18
CLI_REPS = 1  # processes a mode and case (min/median/max over them when above 1)
CLI_TIMEOUT_S = 300
# One CLI process of phase 17: it times its own imports, the CUDA context,
# the first cuBLAS (and, for mean-field, cuSOLVER) call and the FASTA read
# (the engines' read_msa wrapped in place), then runs the CLI's entry point
# on argv and prints one PHASE17 line.  The context and the library handles
# are made first on purpose: the CLI would make them at its first launch.
CLI_RUN = r"""
import json, sys, time
t0 = time.perf_counter()
spec = json.loads(sys.argv[1])
import torch
t1 = time.perf_counter()
from pydca_tpu_torch import meanfield, plm
from pydca_tpu_torch.cli import mfdca_main, plmdca_main
from pydca_tpu_torch.native import fastacodec
from pydca_tpu_torch.ops import cuda_kernels as ck
t2 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t3 = time.perf_counter()
a = torch.ones(64, 64, device="cuda")
(a @ a).sum().item()
t4 = time.perf_counter()
if spec["cli"] == "mfdca":
    torch.linalg.cholesky_ex(a + 64 * torch.eye(64, device="cuda")).L.sum().item()
t5 = time.perf_counter()
reads = []
def timed(read):
    def read_msa(*args, **kw):
        r0 = time.perf_counter()
        msa = read(*args, **kw)
        reads.append(time.perf_counter() - r0)
        return msa
    return read_msa
plm.read_msa = timed(plm.read_msa)
meanfield.read_msa = timed(meanfield.read_msa)
run = plmdca_main.run_plm_dca if spec["cli"] == "plmdca" else mfdca_main.run_meanfield_dca
inst = run(spec["argv"])
torch.cuda.synchronize()
t6 = time.perf_counter()
print("PHASE17 " + json.dumps(dict(
    torch=t1 - t0, port=t2 - t1, context=t3 - t2, cublas=t4 - t3, cusolver=t5 - t4,
    read=sum(reads), cli=t6 - t5, inside=t6 - t0, codec_reads=fastacodec.read_and_encode.reads,
    stages={k: inst.timers.elapsed(k) for k in spec["stages"]},
    ident=ck.identity_counts.launches, gram=ck.weighted_gram.launches)), flush=True)
"""


def cli_env(cache_dir):
    """This process's environment with the build cache at ``cache_dir`` and
    the checkout on the path."""
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    return dict(os.environ, PYDCA_TPU_CACHE_DIR=cache_dir, PYTHONPATH=path)


def run_process(cmd, env, what):
    """Run ``cmd`` to its end; (wall s, stdout).  A failure fails the phase."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{what} failed (exit {proc.returncode}):\n"
          f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    return wall, proc.stdout


def cli_run(case, cache_dir, out_dir, tag):
    """One CLI process of ``case`` with its build cache at ``cache_dir``:
    its wall, its own split, and whether its file equals the reference's."""
    spec = dict(cli=case["cli"], stages=case["stages"],
                argv=case["argv"] + ["--output_dir", out_dir])
    wall, out = run_process([sys.executable, "-c", CLI_RUN, json.dumps(spec)],
                            cli_env(cache_dir), f"phase 17 {case['name']} {tag}")
    lines = [ln for ln in out.splitlines() if ln.startswith("PHASE17 ")]
    check(len(lines) == 1, f"phase 17 {case['name']} {tag}: no PHASE17 line:\n{out[-2000:]}")
    rec = json.loads(lines[0][len("PHASE17 "):])
    with open(os.path.join(out_dir, case["file"]), "rb") as fh:
        rec["same"] = fh.read() == case["bytes"]
    rec["wall"] = wall
    return rec


def spread(xs) -> str:
    """One process's wall, or min/median/max over several."""
    if len(xs) == 1:
        return f"{xs[0]:.3f}"
    return "/".join(f"{v:.3f}" for v in (min(xs), float(np.median(xs)), max(xs)))


def phase_cold_start(tmp, smi, main_fa, mf_fa):
    """Phase 17: the CLI process wall of ``plmdca compute_fn --apc`` on
    phase 3's file and ``mfdca compute_fn --apc`` on phase 6's, as
    subprocesses, CLI_REPS process(es) each: (i) cold, the build cache
    (``PYDCA_TPU_CACHE_DIR``) an empty directory, so nvcc and g++ run in
    the process; (ii) after ``warmup`` into an empty directory (the
    warmup's own wall, then the run's); (iii) warm, the kernels built,
    with each process's split.  Every file must equal the phase's bytes.
    Returns the launches the runs reported."""
    cases = [
        dict(name="plm", cli="plmdca", stages=["weights", "fit", "score"], fa=main_fa,
             kernels=["identity_counts", "plm_passes"],
             argv=["compute_fn", "protein", main_fa, "--apc", "--max_iterations", "100",
                   "--device", cli_device("cuda")],
             file="PLMDCA_apc_fn_scores_planted_protein.txt", ref=os.path.join(tmp, "main")),
        dict(name="mf", cli="mfdca", stages=["weights", "gram", "corr", "inverse", "score"],
             kernels=["identity_counts", "weighted_gram"],
             fa=mf_fa, argv=["compute_fn", "protein", mf_fa, "--apc",
                             "--device", cli_device("cuda")],
             file="MFDCA_apc_fn_scores_planted_mf.txt", ref=os.path.join(tmp, "mf")),
    ]
    launches = dict(ident=0, gram=0)
    for case in cases:
        with open(os.path.join(case["ref"], case["file"]), "rb") as fh:
            case["bytes"] = fh.read()
        runs = {"cold": [], "after warmup": [], "warm": []}
        warmups = []
        warm_dir = None
        for rep in range(CLI_REPS):
            cold_dir = os.path.join(tmp, f"p17_{case['name']}_cold{rep}")
            runs["cold"].append(cli_run(case, cold_dir, os.path.join(cold_dir, "out"), "cold"))
            built = sorted(os.listdir(os.path.join(cold_dir, "torch_build")))
            want = sorted([fastacodec.library_path().name] + [
                _build.library_path(k).name for k in case["kernels"]])
            check(built == want, f"phase 17 {case['name']}: the cold run built {built}, "
                  f"expected {want} (the codec with g++, the kernels with nvcc)")
            warm_dir = os.path.join(tmp, f"p17_{case['name']}_warmup{rep}")
            cmd = [sys.executable, "-m", f"pydca_tpu_torch.cli.{case['cli']}_main", "warmup",
                   "protein", case["fa"], "--device", cli_device("cuda")]
            wall, out = run_process(cmd, cli_env(warm_dir), f"phase 17 {case['name']} warmup")
            check(out.startswith(f"warmed {'plmDCA' if case['cli'] == 'plmdca' else 'mfDCA'} "
                                 "cache for N="), f"phase 17 warmup printed {out!r}")
            warmups.append(wall)
            runs["after warmup"].append(
                cli_run(case, warm_dir, os.path.join(warm_dir, "out"), "after warmup"))
        for rep in range(CLI_REPS):
            runs["warm"].append(cli_run(case, warm_dir, os.path.join(tmp, f"p17_{case['name']}"
                                                                     f"_warm{rep}"), "warm"))
        every = [r for rs in runs.values() for r in rs]
        check(all(r["same"] for r in every),
              f"phase 17 {case['name']}: a run's file differs from its phase's")
        check(all(r["codec_reads"] == 1 for r in every),
              f"phase 17 {case['name']}: a run did not read its FASTA through the codec")
        for r in every:
            launches["ident"] += r["ident"]
            launches["gram"] += r["gram"]
            check(r["ident"] == 1 and r["gram"] == (case["cli"] == "mfdca"),
                  f"phase 17 {case['name']}: launches {r['ident']}, {r['gram']}")
        warm = runs["warm"]
        med = {k: float(np.median([r[k] for r in warm]))
               for k in ("torch", "port", "context", "cublas", "cusolver", "read", "cli",
                         "inside", "wall")}
        stages = {k: float(np.median([r["stages"][k] for r in warm])) for k in case["stages"]}
        start = med["wall"] - med["inside"]
        rest = med["cli"] - med["read"] - sum(stages.values())
        print(f"phase 17 [{smi}] {case['name']} {case['cli']} compute_fn --apc, CLI process wall"
              + ("" if CLI_REPS == 1 else f" min/median/max over {CLI_REPS}")
              + f": cold {spread([r['wall'] for r in runs['cold']])} s "
              f"(nvcc and g++ in the process); warmup {spread(warmups)} s, then "
              f"{spread([r['wall'] for r in runs['after warmup']])} s; warm "
              f"{spread([r['wall'] for r in warm])} s = python start and exit "
              f"{start:.3f} + import torch {med['torch']:.3f} + import the port {med['port']:.3f} "
              f"+ CUDA context {med['context']:.3f} + first cuBLAS call {med['cublas']:.3f}"
              + (f" + first cuSOLVER call {med['cusolver']:.3f}" if case["cli"] == "mfdca" else "")
              + f" + codec read {med['read']:.3f} + stages "
              + " ".join(f"{k} {v:.3f}" for k, v in stages.items())
              + f" + the rest of the CLI (parse, engine, file) {rest:.3f} s; each cold run built "
              f"the codec with g++ and {'/'.join(case['kernels'])} with nvcc; cold minus warm "
              f"{float(np.median([r['wall'] for r in runs['cold']])) - med['wall']:.3f} s; "
              f"all {len(every)} files equal phase {3 if case['cli'] == 'plmdca' else 6}'s byte "
              "for byte, each read through the codec", flush=True)
    return launches


def phase_fasta_decode(tmp, smi, main_fa, deep_fa):
    """Phase 18: ``read_msa`` through the native codec against its Python
    path (``io.fasta._get_native_codec`` patched to ``None``) on phase 3's
    file and on phase 12's codes as FASTA; arrays and ids must be equal."""
    parts = []
    for name, fa in (("phase 3's", main_fa), ("phase 12's", deep_fa)):
        reads = fastacodec.read_and_encode.reads
        t0 = time.perf_counter()
        msa = fasta.read_msa(fa, "protein")
        codec_s = time.perf_counter() - t0
        check(fastacodec.read_and_encode.reads == reads + 1,
              f"phase 18: {name} file was not read through the codec")
        real = fasta._get_native_codec
        fasta._get_native_codec = lambda: None
        try:
            t0 = time.perf_counter()
            slow = fasta.read_msa(fa, "protein")
            python_s = time.perf_counter() - t0
        finally:
            fasta._get_native_codec = real
        check(np.array_equal(msa.data, slow.data) and msa.ids == slow.ids,
              f"phase 18: the codec and the Python path differ on {name} file")
        size = os.path.getsize(fa)
        parts.append(f"{name} file ({size} bytes, {msa.num_seqs} x {msa.seqs_len} after the "
                     f"dedup): codec {codec_s:.3f} s ({size / codec_s / 1e6:.1f} MB/s), Python "
                     f"path {python_s:.3f} s ({size / python_s / 1e6:.1f} MB/s), "
                     f"x{python_s / codec_s:.2f}")
    print(f"phase 18 [{smi}] read_msa, codec (built with g++ at {fastacodec.library_path()}) "
          "against the Python path, arrays and ids equal: " + "; ".join(parts), flush=True)


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


def run_cli(biomolecule, fa, out_dir, device, flags=()):
    inst = plmdca_main.run_plm_dca([
        "compute_fn", biomolecule, fa,
        "--apc", "--max_iterations", "100", "--device", cli_device(device),
        "--output_dir", out_dir, *flags,
    ])
    stem = os.path.splitext(os.path.basename(fa))[0]
    return inst, read_scores(os.path.join(out_dir, f"PLMDCA_apc_fn_scores_{stem}.txt"))


class PhaseClock:
    """Prints the seconds of each phase and of the script so far."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def lap(self, phase: str) -> None:
        now = time.perf_counter()
        print(f"phase {phase} took {now - self.last:.1f} s; the script so far "
              f"{now - self.start:.1f} s", flush=True)
        self.last = now


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--phase16-worker":
        return phase16_worker(sys.argv[2], int(sys.argv[3]))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no card, no result",
              file=sys.stderr)
        return 1
    clock = PhaseClock()

    dev = torch.device("cuda")
    set_precision()

    # ---- phase 1: card and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    fresh = [k for k in LIBRARIES if not _build.library_path(k).exists()]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:  # one nvcc per source
        for fut in [pool.submit(_build.load, k) for k in LIBRARIES]:
            fut.result()
    build_s = time.perf_counter() - t0
    print(f"phase 1 torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; nvcc build of {len(fresh)} "
          f"of {len(LIBRARIES)} libraries in parallel {build_s:.2f} s", flush=True)
    clock.lap("1")

    # ---- phase 2: kernel vs plain version on the card
    max_err, timing = phase_kernel(dev)
    pass_err, pass_timing = phase_plm_passes(dev)
    lbfgs_err, lbfgs_timing = phase_lbfgs(dev)
    clock.lap("2")

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
        pass_launches = plm_pass_launches(res, "phase 3")
        scores_main = scores
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
              f"discarded trials {res.discarded_trials}; "
              f"kernel launches {launches}, {pass_launches}", flush=True)
        clock.lap("3")

        # ---- phase 4: the same RNA-shaped family on the CPU and on the card
        n, l, q = RNA_SHAPE
        codes, _ = planted_family(n, l, q, seed=1, n_pairs=20)
        fa = os.path.join(tmp, "planted_rna.fa")
        write_family_fasta(fa, codes, alphabets.RNA)
        runs = {}
        for device in ("cpu", "cuda"):
            reset_launches()
            t0 = time.perf_counter()
            inst, (_, sc) = run_cli("rna", fa, os.path.join(tmp, device), device)
            runs[device] = (inst, sc, time.perf_counter() - t0)
        rna_passes = plm_pass_launches(runs["cuda"][0].fit_result, "phase 4 (cuda)")
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
              f"{runs['cpu'][2]:.2f} s cuda {runs['cuda'][2]:.2f} s; cuda plm passes "
              f"{rna_passes}", flush=True)
        clock.lap("4")

        plm_fa, plm_runs = fa, runs

        # ---- phases 5-7: the mean-field path
        gram_err, gram_timing = phase_gram(dev)
        clock.lap("5")
        mf_launches, mf_ref = phase_meanfield(tmp)
        clock.lap("6")
        mf_fa, mf_runs = phase_meanfield_cpu_vs_cuda(tmp)
        clock.lap("7")

        # ---- phases 8-10: DI on both paths, compute_params
        phase_plm_di(tmp)
        clock.lap("8")
        phase_mf_di(tmp)
        clock.lap("9")
        phase_di_cpu_vs_cuda(tmp, plm_fa, plm_runs, mf_fa, mf_runs)
        clock.lap("10")

        # ---- phases 11-12: streaming of deep alignments
        stream_inst = phase_stream_cli(tmp, dev)
        clock.lap("11")
        deep_codes, deep_s_eval = phase_stream_deep(dev, tmp)
        clock.lap("12")

        # ---- phases 13-14: checkpoints, family batches
        ckpt_launches = phase_checkpoint(tmp, dev, inst_main, stream_inst)
        del stream_inst
        clock.lap("13")
        fam_ident, fam_gram, fam_ident_err, fam_gram_err = phase_families(tmp, dev, smi)
        clock.lap("14")

        # ---- phase 15: reference sequences (backmapping, search, trimming, evaluator)
        rf, dca_file, ref, planted, ref_ident = phase_refseq_plm(
            tmp, main_fa, main_codes, main_pairs, smi)
        ref_mf = phase_refseq_mf(tmp, mf_fa, mf_runs, smi)
        phase_search_deep(deep_codes, smi, dev)
        deep_fa = os.path.join(tmp, "deep_protein.fa")  # phase 18 reads it
        write_family_fasta(deep_fa, deep_codes, alphabets.PROTEIN)
        phase_trim(tmp, main_fa, rf, smi)
        phase_eval(tmp, rf, dca_file, ref, planted, smi)
        clock.lap("15")

        # ---- phase 19: bfloat16 products (before phase 16, whose two-rank
        # flag case it gives its one-process run)
        reset_launches()
        flag_scores = {"plm_bf16": phase_bf16_cli(tmp, smi, main_fa, inst_main, scores_main)}
        phase_bf16_deep(dev, smi, deep_codes, deep_s_eval)
        del deep_codes
        phase_card_vs_cpu(smi, inst_main)
        p19_ident = ck.identity_counts.launches
        check(p19_ident == 2, f"phase 19 launched identity_counts {p19_ident} times, expected 2 "
              "(one a plm run: (a), (c))")
        print(f"phase 19 kernel launches {{'identity_counts': {p19_ident}}}", flush=True)
        clock.lap("19")

        # ---- phase 16: data parallelism over the sequences (torch.distributed)
        mesh_a = phase_mesh_one_rank(dev, tmp, main_fa, inst_main, mf_ref)
        mesh_bd, walls_b = phase_mesh_two_ranks(tmp, smi, main_fa, scores_main, inst_main,
                                                mf_ref, plm.streaming_block(*DEEP_SHAPE),
                                                flag_scores)
        phase_spawned_ranks(tmp, smi, main_fa, walls_b)
        clock.lap("16")

        # ---- phases 17-18: cold start and warmup, the FASTA decode
        cold = phase_cold_start(tmp, smi, main_fa, mf_ref["fa"])
        clock.lap("17")
        phase_fasta_decode(tmp, smi, main_fa, deep_fa)
        clock.lap("18")

        # ---- phase 20: the model-sharded solve, the multi-rank dryrun
        one_card_peak = phase_solve_one_card(dev, smi, mf_ref)
        grid = phase_grid_two_ranks(tmp, smi, mf_ref, one_card_peak)
        phase_dryrun(smi)
        print(f"phase 20 kernel launches {{'identity_counts': {grid['ident']}, "
              f"'weighted_gram': {grid['gram']}}} ((b)'s two ranks)", flush=True)
        clock.lap("20")

    records = []
    for name, (ms, plain_ms, lib_ms, bound), n_launch, err in (
        ("identity_counts", timing["pf02826_deep"],
         launches + ckpt_launches + fam_ident + ref_ident + ref_mf["identity_counts"]
         + mesh_a["ident"] + mesh_bd["ident"] + cold["ident"] + p19_ident + grid["ident"],
         max(max_err, fam_ident_err)),
        ("weighted_gram", gram_timing["protein"],
         mf_launches + fam_gram + ref_mf["weighted_gram"] + mesh_a["gram"] + mesh_bd["gram"]
         + cold["gram"] + grid["gram"],
         max(gram_err, fam_gram_err)),
    ):
        records.append({
            "name": name, "route": "cuda", "source": f"pydca_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": n_launch, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": lib_ms,
        })
    for name in PLM_PASSES:  # launches: phases 3 and 4 (each checked against its fit)
        ms, plain_ms, lib_ms, bound = pass_timing[(name, "pf02826_deep")]
        records.append({
            "name": name, "route": "cuda", "source": "pydca_tpu_torch/csrc/plm_passes.cu",
            "replaces": None, "stands_for": STANDS_FOR[name],
            "launches": pass_launches[name] + rna_passes[name], "max_rel_err": pass_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": lib_ms,
        })
    for name, (wrapper, stands_for) in LBFGS_KERNELS.items():  # launches: phases 3 and 4
        ms, dev_ms, plain_ms, bound = lbfgs_timing[name]
        records.append({
            "name": name, "route": "cuda", "source": "pydca_tpu_torch/csrc/plm_passes.cu",
            "replaces": None, "stands_for": stands_for, "wrapper": wrapper,
            "launches": pass_launches[wrapper] + rna_passes[wrapper],
            "max_rel_err": lbfgs_err[name], "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
        })
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
