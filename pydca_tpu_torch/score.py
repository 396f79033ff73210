"""DCA scoring: gauge shift, Frobenius norm, APC, direct information, sorting.

Port of ``pydca_tpu/score.py``.  Operates on per-pair coupling blocks of
shape ``(P, q-1, q-1)`` in the canonical pair order (0,1), (0,2), ...,
(L-2, L-1), or on the full (L*(q-1), L*(q-1)) coupling matrix of the
mean-field engine.

The two-site-model fixed point, a ``vmap`` of a ``lax.while_loop`` over
pairs in the JAX package, is one batched loop over all pairs here: each
pair takes its update only while it is live, and the working set is
compacted to the live pairs as they converge (:func:`two_site_model_fields`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .device import sync

__all__ = [
    "gauge_shift",
    "frobenius_norms",
    "frobenius_norms_from_matrix",
    "apc",
    "pair_sites",
    "TwoSiteStats",
    "two_site_model_fields",
    "di_from_fields",
    "direct_information",
    "engine_di",
    "backmapped",
    "params_sites",
    "ranking_method",
    "ranked_pairs",
    "sorted_scores",
]

_TWO_SITE_TOL = 1.0e-4
_TWO_SITE_MAX_ITERS = 10_000  # the reference iterates unboundedly; the JAX package caps
_DI_EPSILON = 1.0e-20
# The fixed point reads the live-pair count on the host every _CHECK_EVERY
# iterations, and compacts the working set to the live pairs when they are
# at most _COMPACT_SHARE of it.
_CHECK_EVERY = 4
_COMPACT_SHARE = 0.5


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
    """Squared gauge-shifted Frobenius norm of every (i, j) block, ``(L, L)``;
    of a row slab of whole sites (``(n_i * q', L * q')``), its ``(n_i, L)`` rows.

    The orthogonal (two-way ANOVA) decomposition of the zero-sum-gauge
    shift (``pydca_tpu/score.py:62-94``): for an n x n block M with row
    sums r, column sums c and total t,

        ||M - rowmean - colmean + mean||_F^2
            = sum M^2 - (sum_a r_a^2)/n - (sum_b c_b^2)/n + t^2/n^2

    reduced over the full coupling matrix with no per-pair gather.  The
    four (L, L) terms are large and nearly equal for weak pairs, so they
    are combined in float64, as the JAX package does under x64.
    """
    j4 = couplings.reshape(-1, qm1, l, qm1)
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
    return fn_from_sq(_fn_matrix_sq(couplings, l, qm1), l)


def fn_from_sq(fn2: torch.Tensor, l: int) -> torch.Tensor:
    """FN scores ``(P,)`` in pair order from the (L, L) squared norms."""
    iu, ju = pair_sites(l, fn2.device)
    return torch.sqrt(torch.clamp_min(fn2[iu, ju], 0.0))


def apc(scores: torch.Tensor, l: int) -> torch.Tensor:
    """Average product correction over per-pair scores ``(P,)`` -> ``(P,)``.

    ``APC(i,j) = s(i,j) - av_i * av_j / av_all`` where ``av_i`` is the mean
    score of pairs containing site ``i`` (over L-1 pairs) and ``av_all`` the
    mean of the ``av_i``.  Reference: ``meanfield_dca.py:968-983``.

    The site sums are row sums of the symmetric (L, L) score matrix, each
    element written once: the same bits in every run on a card, where an
    ``index_add_`` of floats adds in the order its atomics land.
    """
    iu, ju = pair_sites(l, scores.device)
    full = torch.zeros((l, l), dtype=scores.dtype, device=scores.device)
    full[iu, ju] = scores
    full[ju, iu] = scores
    av_sites = full.sum(dim=1) / (l - 1)
    av_all = av_sites.mean()
    return scores - av_sites[iu] * av_sites[ju] / av_all


def pair_sites(l: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(iu, ju)``: the sites of every pair i < j in pair order."""
    return tuple(torch.from_numpy(a).to(device) for a in np.triu_indices(l, k=1))


def _embed_blocks_with_gap(blocks: torch.Tensor, q: int) -> torch.Tensor:
    """Embed (P, q-1, q-1) coupling blocks into (P, q, q) with zero gap row/col.

    Mirrors ``slice_couplings`` (``meanfield_dca/msa_numerics.py:346-374``):
    gap couplings are zero, so ``exp`` of the embedded block is 1 there.
    """
    out = blocks.new_zeros((blocks.shape[0], q, q))
    out[:, : q - 1, : q - 1] = blocks
    return out


class TwoSiteStats(NamedTuple):
    """What the fixed point did: ``iters`` (P,) int32, the iterations each
    pair took; ``live``, one ``(iteration, live pairs, working set)`` per
    host read of the live count (the working set is what that read's
    iterations ran on)."""

    iters: torch.Tensor
    live: List[Tuple[int, int, int]]


def _two_site_step(w, wt, fi, fj, hi, hj, it, active) -> None:
    """One masked fixed-point iteration over a working set, in place.

    Each per-pair product is an elementwise product reduced over the last
    dim, so a pair's result does not depend on which pairs share its batch
    (a batched GEMM's blocking may depend on the batch size).  A pair that
    has stopped keeps its ``hi``, ``hj`` and count.
    """
    xi = (w * hj[:, None, :]).sum(dim=-1)  # sum_b w(a, b) hj(b)
    xj = (wt * hi[:, None, :]).sum(dim=-1)  # sum_a w(a, b) hi(a)
    hi_new = fi / xi
    hi_new = hi_new / hi_new.sum(dim=-1, keepdim=True)
    hj_new = fj / xj
    hj_new = hj_new / hj_new.sum(dim=-1, keepdim=True)
    delta = torch.maximum(
        (hi_new - hi).abs().amax(dim=-1), (hj_new - hj).abs().amax(dim=-1)
    )
    live = active[:, None]
    hi.copy_(torch.where(live, hi_new, hi))
    hj.copy_(torch.where(live, hj_new, hj))
    it.add_(active.to(it.dtype))
    active.logical_and_((delta > _TWO_SITE_TOL) & (it < _TWO_SITE_MAX_ITERS))


def two_site_model_fields(
    blocks: torch.Tensor, fi_reg: torch.Tensor, l: int, q: int, *,
    return_iters: bool = False,
):
    """Per-pair two-site-model fields via fixed-point iteration.

    For every pair (i, j) solves for fields ``(hi, hj)`` such that the
    two-site model ``p(a,b) ~ exp(Jij(a,b)) hi(a) hj(b)`` reproduces the
    regularized marginals ``fi`` and ``fj``.  A pair iterates while its max
    field change exceeds 1e-4 and it has taken fewer than 10^4 iterations,
    exactly as the JAX package's vmapped ``while_loop``
    (``pydca_tpu/score.py:136-182``; reference
    ``pydca/meanfield_dca/msa_numerics.py:377-442``, uncapped).

    All pairs run as one batch until at most half of the working set is
    live; then the live pairs are gathered into a smaller working set and
    the stopped ones scattered back.  The live count is read on the host
    every ``_CHECK_EVERY`` iterations only.

    Returns ``(hi, hj)`` each of shape ``(P, q)``, and with
    ``return_iters=True`` a :class:`TwoSiteStats` as a third element.
    """
    w = torch.exp(_embed_blocks_with_gap(blocks, q))  # (P, q, q)
    wt = w.transpose(1, 2).contiguous()
    iu, ju = pair_sites(l, blocks.device)
    fi_reg = fi_reg.to(device=blocks.device, dtype=blocks.dtype)
    fi, fj = fi_reg[iu], fi_reg[ju]  # (P, q)
    p = w.shape[0]
    hi = torch.full((p, q), 1.0 / q, dtype=blocks.dtype, device=blocks.device)
    hj = hi.clone()
    iters = torch.zeros(p, dtype=torch.int32, device=blocks.device)
    # the working set: all pairs (the full tensors themselves) until the
    # first compaction, then gathered copies of the live pairs at ``idx``
    idx = None
    ws = [w, wt, fi, fj, hi, hj, iters]
    active = torch.ones(p, dtype=torch.bool, device=blocks.device)
    live_log: List[Tuple[int, int, int]] = []
    k = 0
    while True:
        for _ in range(_CHECK_EVERY):
            _two_site_step(*ws, active)
        k += _CHECK_EVERY
        n_live = int(active.sum())  # the one host read of these iterations
        live_log.append((k, n_live, active.shape[0]))
        if n_live == 0 or n_live <= _COMPACT_SHARE * active.shape[0]:
            if idx is not None:  # scatter the working set back
                hi[idx], hj[idx], iters[idx] = ws[4], ws[5], ws[6]
            if n_live == 0:
                break
            keep = active.nonzero().squeeze(1)
            idx = keep if idx is None else idx[keep]
            ws = [t[keep] for t in ws]
            active = active[keep]
    if return_iters:
        return hi, hj, TwoSiteStats(iters, live_log)
    return hi, hj


def di_from_fields(
    blocks: torch.Tensor, hi: torch.Tensor, hj: torch.Tensor,
    fi_reg: torch.Tensor, l: int, q: int,
) -> torch.Tensor:
    """Direct information per pair ``(P,)`` from the two-site fields.

    ``DI = sum_{a,b in residues} pdir(a,b) log(pdir(a,b) / (fi(a) fj(b)))``
    where ``pdir ~ exp(Jij) hi hj`` is normalized over all q x q states but
    the sum runs over the (q-1)^2 residue states only, with epsilon 1e-20
    (``pydca_tpu/score.py:185-204``; reference
    ``pydca/meanfield_dca/msa_numerics.py:445-533``).
    """
    pdir = torch.exp(_embed_blocks_with_gap(blocks, q))
    pdir.mul_(hi[:, :, None]).mul_(hj[:, None, :])
    pdir.div_(pdir.sum(dim=(-2, -1), keepdim=True))
    iu, ju = pair_sites(l, blocks.device)
    fr = fi_reg.to(device=blocks.device, dtype=blocks.dtype)[:, : q - 1]
    pr = pdir[:, : q - 1, : q - 1] + _DI_EPSILON
    del pdir
    fprod = fr[iu][:, :, None] * fr[ju][:, None, :] + _DI_EPSILON
    return (pr * torch.log(pr / fprod)).sum(dim=(-2, -1))


def direct_information(
    blocks: torch.Tensor, fi_reg: torch.Tensor, l: int, q: int
) -> torch.Tensor:
    """Direct information per pair, ``(P,)``: :func:`two_site_model_fields`
    then :func:`di_from_fields`."""
    hi, hj = two_site_model_fields(blocks, fi_reg, l, q)
    return di_from_fields(blocks, hi, hj, fi_reg, l, q)


def engine_di(engine) -> Tuple[torch.Tensor, TwoSiteStats]:
    """An engine's DI ``(P,)`` on its device and the fixed point's
    statistics, in three timed stages of ``engine.timers``: ``blocks`` (the
    coupling blocks and the regularized ``fi``), ``two_site`` (the fixed
    point) and ``di``.  The engine has fitted its couplings already."""
    l, q = engine.msa.seqs_len, engine.msa.q
    timers, device = engine.timers, engine.device
    with timers.stage("blocks"):
        blocks = engine.coupling_blocks()
        fi_reg = engine.get_reg_single_site_freqs()
        sync(device)
    with timers.stage("two_site"):
        hi, hj, stats = two_site_model_fields(blocks, fi_reg, l, q, return_iters=True)
        sync(device)
    with timers.stage("di"):
        di = di_from_fields(blocks, hi, hj, fi_reg, l, q)
        sync(device)
    return di, stats


def backmapped(engine, sorted_dca_scores, seqbackmapper):
    """An engine's sorted scores mapped through ``seqbackmapper`` (none: as
    they are): the pairs whose two MSA columns both map onto the
    reference, renamed by the mapping ({MSA column -> refseq position}), in
    descending score order (``meanfield_dca.py:755-790``,
    ``plmdca.py:527-560``), timed as the stage ``backmap``.  The mapping is
    kept in ``engine.refseq_mapping`` for ``compute_params``."""
    if seqbackmapper is None:
        return sorted_dca_scores
    with engine.timers.stage("backmap"):
        mapping = engine.refseq_mapping = seqbackmapper.map_to_reference_sequence()
        mapped = [((mapping[i], mapping[j]), sc) for (i, j), sc in sorted_dca_scores
                  if i in mapping and j in mapping]
        mapped.sort(key=lambda k: k[1], reverse=True)
        return mapped


def params_sites(engine, seqbackmapper, num_site_pairs: Optional[int]):
    """``compute_params``' sites: ({site -> MSA column}, number of pairs).
    With a backmapper the sites are the reference positions of the mapping
    its ranking just built, and the pairs default to the reference's length;
    else every MSA column and L (``meanfield_dca.py:661-752``,
    ``plmdca.py:345-434``)."""
    l = engine.msa.seqs_len
    if seqbackmapper is None:
        sites, default = {i: i for i in range(l)}, l
    else:
        sites = {v: k for k, v in engine.refseq_mapping.items()}
        default = len(seqbackmapper.ref_sequence)
    return sites, default if num_site_pairs is None else num_site_pairs


def ranking_method(engine, ranked_by: Optional[str], exc_type):
    """``compute_params``' ranking: the engine's sorted-score method named
    by ``ranked_by`` (default FN_APC, any case; ``meanfield_dca.py:661-752``,
    ``plmdca.py:345-434``)."""
    key = ("fn_apc" if ranked_by is None else ranked_by).strip().upper()
    methods = {
        "FN": engine.compute_sorted_FN,
        "FN_APC": engine.compute_sorted_FN_APC,
        "DI": engine.compute_sorted_DI,
        "DI_APC": engine.compute_sorted_DI_APC,
    }
    if key not in methods:
        raise exc_type(f"invalid ranking criterion {key}; choose from {tuple(methods)}")
    return methods[key]


def ranked_pairs(sorted_dca_scores, linear_dist: int, num_site_pairs: int):
    """The first ``num_site_pairs`` pairs of a sorted score list whose sites
    lie more than ``linear_dist`` apart: the pairs ``compute_params``
    extracts couplings for."""
    out = []
    for pair, _ in sorted_dca_scores:
        if abs(pair[0] - pair[1]) > linear_dist:
            if len(out) >= num_site_pairs:
                break
            out.append(pair)
    return out


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
