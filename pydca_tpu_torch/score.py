"""DCA scoring, FN half: gauge shift, Frobenius norm, APC, sorting.

Port of the FN part of ``pydca_tpu/score.py``.  Operates on per-pair
coupling blocks of shape ``(P, q-1, q-1)`` in the canonical pair order
(0,1), (0,2), ..., (L-2, L-1).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

__all__ = ["gauge_shift", "frobenius_norms", "apc", "sorted_scores"]


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
