"""MSA statistics for the plmDCA and mean-field paths, in PyTorch.

Port of ``pydca_tpu/stats.py``: sequence weights from all-pairs identity
counts and the weighted one-hot Gram matrix (each a hand-written CUDA
kernel on a card), single-site and pair-site frequencies, pseudocount
regularisation, the mean-field correlation matrix and the pair-index
helpers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops import cuda_kernels
from .ops.cuda_kernels import identity_counts

__all__ = [
    "sequence_weights",
    "single_site_freqs",
    "weighted_gram",
    "pair_site_freqs",
    "pair_freqs_from_gram",
    "regularize_fi",
    "regularize_fij",
    "corr_mat_from_gram",
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


def weighted_gram(msa: torch.Tensor, weights: torch.Tensor, q: int) -> torch.Tensor:
    """Weighted co-occurrence Gram matrix ``F`` of shape ``(L*q, L*q)``.

    ``F[(i,a),(j,b)] = sum_n w_n [s_ni == a][s_nj == b] / Meff``.  Its
    block diagonal holds ``fi`` (``F[(i,a),(i,a)] = fi[i,a]``) and every
    ``i != j`` block is the pair table ``fij``
    (``pydca_tpu/stats.py:213-235``).  On a CUDA tensor the sums come from
    the CUDA kernel ``csrc/weighted_gram.cu``; the division by Meff is in
    place.
    """
    return cuda_kernels.weighted_gram(msa, weights, q).div_(weights.sum())


def pair_site_freqs(msa: torch.Tensor, weights: torch.Tensor, q: int) -> torch.Tensor:
    """Pair-site frequencies ``fij`` of shape ``(P, q-1, q-1)`` in pair order
    (0,1), (0,2), ..., (L-2,L-1), gap excluded (the mean-field convention)."""
    return pair_freqs_from_gram(weighted_gram(msa, weights, q), msa.shape[1], q)


def pair_freqs_from_gram(gram: torch.Tensor, l: int, q: int) -> torch.Tensor:
    """The ``i < j`` blocks of a Gram matrix from :func:`weighted_gram`
    without the gap state (``q-1``, last): ``(P, q-1, q-1)`` in pair order."""
    iu, ju = np.triu_indices(l, k=1)
    return gram.reshape(l, q, l, q)[:, : q - 1, :, : q - 1].permute(0, 2, 1, 3)[iu, ju]


def regularize_fi(fi, q: int, pseudocount: float):
    """``f <- theta/q + (1-theta) f``  (``msa_numerics.py:92-125``)."""
    return pseudocount / q + (1.0 - pseudocount) * fi


def regularize_fij(fij, q: int, pseudocount: float):
    """``f <- theta/q^2 + (1-theta) f``  (``msa_numerics.py:231-267``)."""
    return pseudocount / (q * q) + (1.0 - pseudocount) * fij


def corr_mat_from_gram(
    gram: torch.Tensor,
    fi_reg: torch.Tensor,
    pseudocount: float,
    l: int,
    q: int,
) -> torch.Tensor:
    """Mean-field correlation matrix ``C`` of shape ``(L*(q-1), L*(q-1))``.

    Off-diagonal blocks ``C[(i,a),(j,b)] = fij_reg(i,j,a,b) - fi_reg(i,a)
    fi_reg(j,b)``; diagonal blocks ``fi_reg(i,a) (delta_ab - fi_reg(i,b))``
    (``pydca_tpu/stats.py:284-315``).  ``gram`` is the raw Gram matrix of
    :func:`weighted_gram`; the gap state (``q-1``, last) of every site is
    dropped.  ``C`` has the Gram's dtype.

    Built in place: one (D, D) allocation receives the gap-free copy of the
    Gram, and the regularisation, the zeroed diagonal blocks, ``diag(fr)``
    and the rank-1 term ``- fr fr'`` are applied to it where it lies, where
    the JAX form materialises ``diag(fr)`` and several more (D, D)
    temporaries.
    """
    qm1 = q - 1
    d = l * qm1
    c = torch.empty((d, d), dtype=gram.dtype, device=gram.device)
    c4 = c.view(l, qm1, l, qm1)
    c4.copy_(gram.reshape(l, q, l, q)[:, :qm1, :, :qm1])
    c.mul_(1.0 - pseudocount).add_(pseudocount / (q * q))
    c4.diagonal(dim1=0, dim2=2).zero_()  # the (i, i) blocks
    fr = fi_reg[:, :qm1].reshape(-1).to(gram.dtype)
    c.diagonal().add_(fr)
    return c.addr_(fr, fr, alpha=-1)


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
