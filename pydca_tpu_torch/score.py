"""DCA scoring, FN half: gauge shift, Frobenius norm, APC, sorting.

Port of the FN part of ``pydca_tpu/score.py``.  Operates on per-pair
coupling blocks of shape ``(P, q-1, q-1)`` in the canonical pair order
(0,1), (0,2), ..., (L-2, L-1), or on the full (L*(q-1), L*(q-1)) coupling
matrix of the mean-field engine.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

__all__ = [
    "gauge_shift",
    "frobenius_norms",
    "frobenius_norms_from_matrix",
    "apc",
    "sorted_scores",
]


def gauge_shift(blocks: torch.Tensor) -> torch.Tensor:
    """Zero-sum-gauge shift per coupling block: ``J - rowmean - colmean + mean``.

    ``blocks``: (..., q', q').  Reference: ``meanfield_dca.py:636-658``.
    """
    avx = blocks.mean(dim=-1, keepdim=True)
    avy = blocks.mean(dim=-2, keepdim=True)
    av = blocks.mean(dim=(-2, -1), keepdim=True)
    return blocks - avx - avy + av


def frobenius_norms(blocks: torch.Tensor) -> torch.Tensor:
    """Frobenius norm of gauge-shifted coupling blocks: ``(P,)`` scores.

    Reference: ``meanfield_dca.py:926-940`` / ``plmdca.py:461-477``.
    """
    shifted = gauge_shift(blocks)
    return torch.sqrt((shifted * shifted).sum(dim=(-2, -1)))


def _fn_matrix_sq(couplings: torch.Tensor, l: int, qm1: int) -> torch.Tensor:
    """Squared gauge-shifted Frobenius norm of every (i, j) block, ``(L, L)``.

    The orthogonal (two-way ANOVA) decomposition of the zero-sum-gauge
    shift (``pydca_tpu/score.py:62-94``): for an n x n block M with row
    sums r, column sums c and total t,

        ||M - rowmean - colmean + mean||_F^2
            = sum M^2 - (sum_a r_a^2)/n - (sum_b c_b^2)/n + t^2/n^2

    reduced over the full coupling matrix with no per-pair gather.  The
    four (L, L) terms are large and nearly equal for weak pairs, so they
    are combined in float64, as the JAX package does under x64.
    """
    j4 = couplings.reshape(l, qm1, l, qm1)
    n = qm1
    sq = (j4 * j4).sum(dim=(1, 3))  # (L, L)
    rs = j4.sum(dim=3)  # (L, n, L): row sums of block (i, j)
    cs = j4.sum(dim=1)  # (L, L, n): column sums
    tot = rs.sum(dim=1)  # (L, L)
    f64 = torch.float64
    out = (
        sq.to(f64)
        - (rs * rs).sum(dim=1).to(f64) / n
        - (cs * cs).sum(dim=2).to(f64) / n
        + (tot * tot).to(f64) / (n * n)
    )
    return out.to(couplings.dtype)


def frobenius_norms_from_matrix(
    couplings: torch.Tensor, l: int, qm1: int
) -> torch.Tensor:
    """FN scores ``(P,)`` in pair order from a full (L*q', L*q') coupling
    matrix: :func:`frobenius_norms` over its per-pair blocks, computed with
    block reductions over the matrix itself (``pydca_tpu/score.py:97-106``).
    """
    fn2 = _fn_matrix_sq(couplings, l, qm1)
    iu, ju = (torch.from_numpy(a).to(fn2.device) for a in np.triu_indices(l, k=1))
    return torch.sqrt(torch.clamp_min(fn2[iu, ju], 0.0))


def apc(scores: torch.Tensor, l: int) -> torch.Tensor:
    """Average product correction over per-pair scores ``(P,)`` -> ``(P,)``.

    ``APC(i,j) = s(i,j) - av_i * av_j / av_all`` where ``av_i`` is the mean
    score of pairs containing site ``i`` (over L-1 pairs) and ``av_all`` the
    mean of the ``av_i``.  Reference: ``meanfield_dca.py:968-983``.
    """
    iu, ju = (torch.from_numpy(a).to(scores.device) for a in np.triu_indices(l, k=1))
    site_sums = torch.zeros(l, dtype=scores.dtype, device=scores.device)
    site_sums.index_add_(0, iu, scores).index_add_(0, ju, scores)
    av_sites = site_sums / (l - 1)
    av_all = av_sites.mean()
    return scores - av_sites[iu] * av_sites[ju] / av_all


def sorted_scores(scores, l: int) -> List[Tuple[Tuple[int, int], float]]:
    """Convert per-pair scores ``(P,)`` into the reference's sorted list form
    ``[((i, j), score), ...]`` in descending score order (0-based sites).
    """
    if isinstance(scores, torch.Tensor):
        scores = scores.detach().cpu().numpy()
    scores = np.asarray(scores)
    iu, ju = np.triu_indices(l, k=1)
    order = np.argsort(-scores, kind="stable")
    return [((int(iu[k]), int(ju[k])), float(scores[k])) for k in order]
