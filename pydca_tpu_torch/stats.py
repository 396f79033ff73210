"""MSA statistics for the plmDCA and mean-field paths, in PyTorch.

Port of ``pydca_tpu/stats.py``: sequence weights from all-pairs identity
counts and the weighted one-hot Gram matrix (each a hand-written CUDA
kernel on a card), single-site and pair-site frequencies, pseudocount
regularisation, the mean-field correlation matrix and the pair-index
helpers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .ops import cuda_kernels
from .ops.cuda_kernels import identity_counts

__all__ = [
    "sequence_weights",
    "sharded_weights_full",
    "single_site_freqs",
    "weighted_counts",
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
    mesh=None,
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

    ``mesh`` (a :class:`~pydca_tpu_torch.parallel.mesh.DataMesh`): ``msa``
    and ``valid`` are this rank's stripe.  The stripes are all-gathered,
    each rank counts its share of the kernel's tiles, the partial counts
    are summed over the ranks (exactly: integers), and the result is this
    rank's stripe of weights with 0 on the rows that are not valid
    (the twin of ``pydca_tpu/parallel/fit.py:83-97``).
    """
    n, l = msa.shape
    thr = float(np.float32(float(seqid) * l))
    if mesh is not None:
        if valid is None:
            valid = torch.ones(n, dtype=torch.bool, device=msa.device)
        codes = mesh.gather_rows(msa.to(torch.int8), "weights_allgather")
        vfull = mesh.gather_rows(valid.to(torch.bool), "weights_allgather")
        w = sharded_weights_full(mesh, codes, vfull, thr, q, dtype)
        return w[mesh.rank * n : (mesh.rank + 1) * n]
    sims = identity_counts(msa, thr, q, valid=valid)
    if valid is not None:
        sims = torch.clamp_min(sims, 1)  # pad rows: avoid 1/0; caller masks them
    return 1.0 / sims.to(dtype)


def sharded_weights_full(mesh, codes, valid, thr: float, q: int, dtype) -> torch.Tensor:
    """Weights of every row of the whole (padded) alignment ``codes``, held
    by every rank: this rank's share of the identity-count tiles
    (``ops.cuda_kernels.identity_tile_share``), the (N,) int32 partial
    counts summed over the ranks, ``1/m`` with 0 where ``valid`` is False."""
    tiles = cuda_kernels.identity_tile_share(codes.shape[0], mesh.rank, mesh.world_size)
    sims = identity_counts(codes, thr, q, valid=valid, tiles=tiles)
    mesh.sum_(sims, "weights_allreduce")
    w = 1.0 / torch.clamp_min(sims, 1).to(dtype)
    return torch.where(valid, w, torch.zeros((), dtype=dtype, device=w.device))


def single_site_freqs(
    msa: torch.Tensor, weights: torch.Tensor, q: int, block: Optional[int] = None,
    mesh=None,
) -> torch.Tensor:
    """Weighted single-site frequencies ``fi`` of shape ``(L, q)``.

    ``fi[i, a] = sum_n w_n [msa[n, i] == a] / Meff``
    (reference: ``pydca/meanfield_dca/msa_numerics.py:53-89``).  A weighted
    sum in the weights' dtype (float32 with TF32 off: the JAX package runs
    this contraction at ``Precision.HIGHEST``, ``stats.py:209``).
    ``block``: add the sums up over blocks of this many sequences, so that
    at most one block's one-hot is alive (the streamed plm route).
    ``mesh``: ``msa`` and ``weights`` are this rank's stripe; the counts
    and Meff are summed over the ranks.
    """
    counts, meff = weighted_counts(msa, weights, q, block, mesh)
    return counts / meff


def weighted_counts(msa: torch.Tensor, weights: torch.Tensor, q: int,
                    block: Optional[int] = None, mesh=None):
    """``(counts, Meff)``: the (L, q) weighted state counts
    ``sum_n w_n [msa[n, i] == a]`` and the weights' sum, each summed over
    the mesh's ranks (one collective) when a mesh is given."""
    n, l = msa.shape
    step = max(n, 1) if block is None else int(block)
    both = torch.zeros(l * q + 1, dtype=weights.dtype, device=weights.device)
    counts = both[: l * q]
    for start in range(0, n, step):
        x = torch.nn.functional.one_hot(msa[start : start + step].long(), q).to(weights.dtype)
        counts.add_(weights[start : start + step] @ x.reshape(-1, l * q))
    both[-1] = weights.sum()
    if mesh is not None:
        mesh.sum_(both, "fi_allreduce")
    return counts.reshape(l, q), both[-1]


def weighted_gram(msa: torch.Tensor, weights: torch.Tensor, q: int, mesh=None) -> torch.Tensor:
    """Weighted co-occurrence Gram matrix ``F`` of shape ``(L*q, L*q)``.

    ``F[(i,a),(j,b)] = sum_n w_n [s_ni == a][s_nj == b] / Meff``.  Its
    block diagonal holds ``fi`` (``F[(i,a),(i,a)] = fi[i,a]``) and every
    ``i != j`` block is the pair table ``fij``
    (``pydca_tpu/stats.py:213-235``).  On a CUDA tensor the sums come from
    the CUDA kernel ``csrc/weighted_gram.cu``; the division by Meff is in
    place.  ``mesh``: ``msa`` and ``weights`` are this rank's stripe; the
    kernel sums the stripe's rows, and the unnormalised Gram and Meff are
    summed over the ranks before the division.
    """
    gram = cuda_kernels.weighted_gram(msa, weights, q)
    meff = weights.sum()
    if mesh is not None:
        mesh.sum_(gram, "gram_allreduce")
        mesh.sum_(meff, "meff_allreduce")
    return gram.div_(meff)


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
    sites: Optional[Tuple[int, int]] = None,
    l_pad: Optional[int] = None,
) -> torch.Tensor:
    """Mean-field correlation matrix ``C`` of shape ``(L*(q-1), L*(q-1))``.

    Off-diagonal blocks ``C[(i,a),(j,b)] = fij_reg(i,j,a,b) - fi_reg(i,a)
    fi_reg(j,b)``; diagonal blocks ``fi_reg(i,a) (delta_ab - fi_reg(i,b))``
    (``pydca_tpu/stats.py:284-315``).  ``gram`` is the raw Gram matrix of
    :func:`weighted_gram`; the gap state (``q-1``, last) of every site is
    dropped.  ``C`` has the Gram's dtype.

    ``l_pad`` (at least L) pads C to ``l_pad`` sites with an identity
    block: the padded C is block diagonal, its inverse's real block is
    C's inverse.  ``sites = (s0, s1)`` builds only the rows of sites
    ``[s0, s1)`` of the (padded) C, over all its columns: a row slab of
    the model-sharded solve.

    Built in place: one allocation receives the gap-free copy of the
    Gram, and the regularisation, the zeroed diagonal blocks, ``diag(fr)``
    and the rank-1 term ``- fr fr'`` are applied to it where it lies, where
    the JAX form materialises ``diag(fr)`` and several more (D, D)
    temporaries.
    """
    qm1 = q - 1
    lp = l if l_pad is None else int(l_pad)
    s0, s1 = (0, lp) if sites is None else sites
    nr = max(min(s1, l) - s0, 0)  # the slab's real sites
    alloc = torch.empty if lp == l else torch.zeros
    c = alloc(((s1 - s0) * qm1, lp * qm1), dtype=gram.dtype, device=gram.device)
    c4 = c.view(s1 - s0, qm1, lp, qm1)[:nr, :, :l]
    c4.copy_(gram.reshape(l, q, l, q)[s0 : s0 + nr, :qm1, :, :qm1])
    c4.mul_(1.0 - pseudocount).add_(pseudocount / (q * q))
    c4[:, :, s0 : s0 + nr].diagonal(dim1=0, dim2=2).zero_()  # the (i, i) blocks
    fr = fi_reg[:, :qm1].reshape(-1).to(gram.dtype)
    diag = c.diagonal(offset=s0 * qm1)
    diag[: nr * qm1].add_(fr[s0 * qm1 : (s0 + nr) * qm1])
    diag[nr * qm1 :].fill_(1.0)  # the pad sites' identity block
    c[: nr * qm1, : l * qm1].addr_(fr[s0 * qm1 : (s0 + nr) * qm1], fr, alpha=-1)
    return c


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
