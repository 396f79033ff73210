"""MSA statistics for the plmDCA main path, in PyTorch.

Port of the plmDCA half of ``pydca_tpu/stats.py``: sequence weights from
all-pairs identity counts (the hand-written CUDA kernel on a card),
weighted single-site frequencies and the pair-index helpers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops.cuda_kernels import identity_counts

__all__ = [
    "sequence_weights",
    "single_site_freqs",
    "pair_index",
    "pair_index_matrix",
]


def sequence_weights(
    msa: torch.Tensor,
    seqid: float,
    q: int,
    *,
    dtype: torch.dtype = torch.float32,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-sequence reweighting factors ``w_i = 1 / m_i``.

    ``m_i`` counts sequences (including ``i`` itself) whose fractional
    identity with ``i`` exceeds ``seqid`` *strictly*
    (reference: ``pydca/meanfield_dca/msa_numerics.py:41-49``):
    ``iid / L > seqid  <=>  iid > float32(seqid * L)``, the float32
    threshold the JAX package compares against (``stats.py:166,181``).

    On a CUDA tensor the counts come from the CUDA kernel at every N (the
    TPU's crossover ``PALLAS_MIN_N`` was measured on a TPU and does not
    carry over).  ``valid``: optional (N,) bool mask; rows with
    ``valid = False`` are excluded from every neighbour count and their
    own weight is meaningless (the caller masks it).
    """
    n, l = msa.shape
    thr = float(np.float32(float(seqid) * l))
    sims = identity_counts(msa, thr, q, valid=valid)
    if valid is not None:
        sims = torch.clamp_min(sims, 1)  # pad rows: avoid 1/0; caller masks them
    return 1.0 / sims.to(dtype)


def single_site_freqs(
    msa: torch.Tensor, weights: torch.Tensor, q: int
) -> torch.Tensor:
    """Weighted single-site frequencies ``fi`` of shape ``(L, q)``.

    ``fi[i, a] = sum_n w_n [msa[n, i] == a] / Meff``
    (reference: ``pydca/meanfield_dca/msa_numerics.py:53-89``).  A weighted
    sum in the weights' dtype (float32 with TF32 off: the JAX package runs
    this contraction at ``Precision.HIGHEST``, ``stats.py:209``).
    """
    n, l = msa.shape
    x = torch.nn.functional.one_hot(msa.long(), q).to(weights.dtype)
    fi = (weights @ x.reshape(n, l * q)).reshape(l, q)
    return fi / weights.sum()


def pair_index(i, j, l: int):
    """Closed-form index of pair ``(i, j)``, ``i < j``, in row-major pair order.

    ``P(i,j) = L(L-1)/2 - (L-i)(L-i-1)/2 + j - i - 1``
    (reference: ``pydca/meanfield_dca/msa_numerics.py:220``).
    """
    return (l * (l - 1)) // 2 - ((l - i) * (l - i - 1)) // 2 + j - i - 1


def pair_index_matrix(l: int) -> np.ndarray:
    """(L, L) int32 matrix M with M[i, j] = pair_index(min,max) (diag = 0)."""
    ii, jj = np.meshgrid(np.arange(l), np.arange(l), indexing="ij")
    lo, hi = np.minimum(ii, jj), np.maximum(ii, jj)
    m = (l * (l - 1)) // 2 - ((l - lo) * (l - lo - 1)) // 2 + hi - lo - 1
    np.fill_diagonal(m, 0)
    return m.astype(np.int32)
