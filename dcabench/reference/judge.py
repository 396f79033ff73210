"""The comparison that decides ``correct``: each number the benchmark
compares, worked out from one job's outputs and the reference.

plmDCA:

- ``weights_max_abs``: largest gap between the program's sequence weights
  and the reference's (exact: 0).
- ``objective_gap``: how much higher the float64 objective stands at the
  program's fitted parameters than at the reference's fit
  (:func:`..plm.fit`, float64, the same algorithm from pydca's start) after
  as many iterations as the program made, ``(f(theta) - f_ref_k) /
  |f_ref_k|``.  A float32 fit and the reference part ways only in the
  last iterations, where the float32 objective can no longer resolve a
  step's decrease, and along directions in which the objective is flat; a
  fit in a lower precision ends measurably higher.
- ``stop_gap``: the same gap against the reference stopped by the CLI's
  rule (``max_iterations``, or libLBFGS's ``||g|| / max(1, ||x||) <=
  epsilon`` with ``epsilon`` 1e-3), ``(f(theta) - f_ref) / |f_ref|``: a
  fit that stops where float32 can no longer find a decrease ends a little
  above it; a fit cut short, or one that returns its start, ends far above.
- ``fnapc_gap``: the program's ranked FN-APC scores against the float64
  FN-APC of its own parameters, over the largest |score|.
- ``list_errors``: pairs missing or repeated in the ranked list, and
  neighbours out of order (exact: 0).

Mean-field (one solve, worked out again whole): ``weights_max_abs``,
``couplings_gap`` (the program's ``-C^{-1}`` against the float64
reference's, largest gap over the largest |J|), ``fnapc_gap`` (against the
reference's own FN-APC) and ``list_errors``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import meanfield as ref_mf
from . import plm as ref_plm
from .weights import sequence_weights

Ranked = Sequence[Tuple[Tuple[int, int], float]]
EPSILON = 1e-3  # the CLI's stop test (libLBFGS's default epsilon)


def ranked_scores(ranked: Ranked, l: int) -> Tuple[np.ndarray, int]:
    """The list's scores in pair order (NaN where a pair is missing) and
    the count of errors: pairs missing, repeated or not a pair ``i < j``
    of L sites, and neighbours whose scores increase down the list."""
    p = l * (l - 1) // 2
    out = np.full(p, np.nan)
    errors = 0
    prev = np.inf
    for (i, j), s in ranked:
        i, j, s = int(i), int(j), float(s)
        if not 0 <= i < j < l:
            errors += 1
            continue
        k = p - (l - i) * (l - i - 1) // 2 + j - i - 1
        if not np.isnan(out[k]):
            errors += 1
        out[k] = s
        if s > prev:
            errors += 1
        prev = s
    errors += int(np.isnan(out).sum())
    return out, errors


def _score_gap(prog: np.ndarray, ref: torch.Tensor) -> float:
    """Largest gap over the pairs the list holds (a missing pair is a list
    error), over the largest |reference score|."""
    ref = ref.detach().cpu().numpy()
    return float(np.nanmax(np.abs(prog - ref)) / (np.abs(ref).max() or 1.0))


def _weights_gap(prog, ref: torch.Tensor) -> float:
    prog = torch.as_tensor(prog).to(ref.device, torch.float32)
    return float((prog - ref).abs().max())


class PlmJudge:
    """Numbers of plmDCA jobs; one reference fit a family, stopped by the
    CLI's rule, serves every job of that family."""

    def __init__(self, l: int, q: int, seqid: float, lambda_h: float, lambda_j: float,
                 device, block: int = 8192, max_iterations: int = 100):
        self.l, self.q, self.seqid = l, q, seqid
        self.max_iterations = max_iterations
        self.lambda_h, self.lambda_j = lambda_h, lambda_j
        self.device, self.block = torch.device(device), block
        self._fits: Dict[object, Tuple[torch.Tensor, object]] = {}

    def _reference(self, key, codes: torch.Tensor, iters: Optional[int] = None):
        """The weights and the reference fit (to ``iters`` iterations when
        given, else by the CLI's rule, kept for the family)."""
        if key not in self._fits:
            w = sequence_weights(codes, self.seqid, self.q)
            self._fits[key] = (w, ref_plm.fit(
                codes, w, self.lambda_h, self.lambda_j, self.l, self.q,
                max_iterations=self.max_iterations, epsilon=EPSILON, block=self.block))
        w, fit = self._fits[key]
        if iters is not None:
            fit = ref_plm.fit(codes, w, self.lambda_h, self.lambda_j, self.l, self.q,
                              max_iterations=iters, epsilon=0.0, block=self.block)
        return w, fit

    def numbers(self, key, codes_np: np.ndarray, weights, theta, iters: int,
                ranked: Ranked) -> Dict[str, float]:
        codes = torch.from_numpy(np.ascontiguousarray(codes_np)).to(self.device)
        w, ref = self._reference(key, codes)
        f_k = ref.fx_path[min(int(iters), len(ref.fx_path) - 1)]
        theta = torch.as_tensor(np.asarray(theta)).to(self.device, torch.float64)
        f, _ = ref_plm.objective(theta, codes, w, self.lambda_h, self.lambda_j, self.l, self.q,
                                 block=self.block)
        scores, errors = ranked_scores(ranked, self.l)
        return {
            "weights_max_abs": _weights_gap(weights, w),
            "objective_gap": (f - f_k) / abs(f_k),
            "stop_gap": (f - ref.fx) / abs(ref.fx),
            "fnapc_gap": _score_gap(scores, ref_plm.fn_apc(theta, self.l, self.q)),
            "list_errors": float(errors),
        }

    def look(self, key, codes_np: np.ndarray, theta, iters: int, ranked: Ranked
             ) -> Dict[str, float]:
        """Readings beside the compared ones, for choosing them: the
        parameter gap, by part and in the zero-sum gauge, the FN-APC gap to
        the reference's iterate, the float64 gradients' gap, the
        reference's evaluations to compare with the program's, and the
        path of the reference stopped by the CLI's rule."""
        l, q = self.l, self.q
        codes = torch.from_numpy(np.ascontiguousarray(codes_np)).to(self.device)
        w, ref_k = self._reference(key, codes, int(iters))
        theta_ref = ref_k.theta
        _, ref = self._reference(key, codes)
        theta = torch.as_tensor(np.asarray(theta)).to(self.device, torch.float64)

        def rel(a, b):
            return float((a - b).norm() / b.norm())

        def gauge(t, k):
            return ref_plm.gauge_blocks(t[l * q:].reshape(-1, q, q)[:, :k, :k])

        def obj(t):
            return ref_plm.objective(t, codes, w, self.lambda_h, self.lambda_j, l, q,
                                     block=self.block)

        _, g0 = obj(ref_plm.init_theta(codes, w, l, q))
        _, g = obj(theta)
        _, g_ref = obj(theta_ref)
        scores, _ = ranked_scores(ranked, l)
        return {
            "params_gap": rel(theta, theta_ref),
            "h_gap": rel(theta[: l * q], theta_ref[: l * q]),
            "j_gap": rel(theta[l * q:], theta_ref[l * q:]),
            "gauge_gap": rel(gauge(theta, q), gauge(theta_ref, q)),
            "gauge_gap_nogap": rel(gauge(theta, q - 1), gauge(theta_ref, q - 1)),
            "fnapc_ref_gap": _score_gap(scores, ref_plm.fn_apc(theta_ref, l, q)),
            "grad_gap": float((g - g_ref).norm() / g0.norm()),
            "ref_evals": ref_k.n_evals,
            "ref_iters": ref.num_iters,
            "ref_fx_path": list(ref.fx_path),
        }


class MeanFieldJudge:
    """Numbers of mean-field jobs; the reference's solve is kept per family."""

    def __init__(self, l: int, q: int, seqid: float, pseudocount: float, device,
                 block: int = 8192):
        self.l, self.q, self.seqid, self.pc = l, q, seqid, pseudocount
        self.device, self.block = torch.device(device), block
        self._ref: Dict[object, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}

    def _family(self, key, codes: torch.Tensor):
        if key not in self._ref:
            w = sequence_weights(codes, self.seqid, self.q)
            j = ref_mf.couplings(codes, w, self.q, self.pc, block=self.block)
            self._ref[key] = (w, j, ref_mf.fn_apc(j, self.l, self.q))
        return self._ref[key]

    def numbers(self, key, codes_np: np.ndarray, weights, couplings, ranked: Ranked
                ) -> Dict[str, float]:
        codes = torch.from_numpy(np.ascontiguousarray(codes_np)).to(self.device)
        w, j, s = self._family(key, codes)
        jp = torch.as_tensor(couplings).to(self.device)
        gap = 0.0
        for r0 in range(0, j.shape[0], 1024):  # row blocks: no second (D, D) float64 copy
            rows = jp[r0:r0 + 1024].to(torch.float64) - j[r0:r0 + 1024]
            gap = max(gap, float(rows.abs().max()))
        scores, errors = ranked_scores(ranked, self.l)
        return {
            "weights_max_abs": _weights_gap(weights, w),
            "couplings_gap": gap / float(j.abs().max()),
            "fnapc_gap": _score_gap(scores, s),
            "list_errors": float(errors),
        }


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over the jobs judged."""
    return {k: max(r[k] for r in readings) for k in readings[0]} if readings else {}
