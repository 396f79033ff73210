"""Family batches: many MSAs of one biomolecule in one call, in PyTorch.

Port of ``pydca_tpu/family.py``.  :class:`FamilyBatch` is the JAX
package's padded ``(F, Nmax, Lmax)`` host layout (the API and the tests
use it).  On the device:

- weights: the identity counts of each family at its own ``(N_f, L_f)``
  (the CUDA ``identity_counts`` kernel on a card, one launch a family, the
  pad token never reaching it) against ``float32(seqid * L_f)``, weights
  ``1 / max(count, 1)`` as the JAX family path has them
  (``family.py:127``; the single-family weights are ``1 / count``, which
  differs at ``seqid = 1.0``), zero on pad rows;
- plmDCA: the families of a batch are fitted in lock-step, the port of
  ``_family_fit_impl``'s ``vmap`` of ``lbfgs_init`` + ``lbfgs_steps``:
  one generic L-BFGS loop over F lanes (``ops/lbfgs.lbfgs_steps_batch``),
  whose every round is one batched evaluation and one host read for all
  lanes, running until the slowest lane is done.  The lanes share the
  batch's own maxima ``(Nb, Lb)``: the masked objective
  (``_family_plm_loss``) over the ``(F, Nb, Lb)`` block, pad rows at weight
  0, pad sites (the pad token ``q``, an all-zero one-hot row) masked out of
  the per-site sum, ``torch.bmm`` for the logits products and autograd for
  the gradient; ``lambda = 0.2 (L_f - 1)`` a lane; each lane starts from
  the reference init of its own codes, placed into the ``Lb`` layout with
  every pad entry 0, where the L2 term keeps it.  :func:`family_plm_fit`
  fits the whole batch so (``--no_bucket``); :func:`family_plm_fit_bucketed`
  fits each (N, L) bucket of :func:`bucket_families` so, and scores each
  family from its own parameters as soon as its batch ends.  A batch whose
  lanes would pass ``LOCKSTEP_MAX_BYTES`` runs as consecutive sub-batches,
  each in lock-step.  ``pad_to`` only places the returned parameters:
  the power-of-two bounds of the JAX package exist for XLA's compiled
  shapes.  :func:`_fit_one`, one family's fit at its own shape, is the
  per-family reference of the tests and of ``chip_smoke.py``;
- mean-field: the weighted Gram (the CUDA ``weighted_gram`` kernel), ``C``
  and its SPD inverse, family after family at its own shape: JAX's
  identity rows on pad sites make its inverse block-diagonal, and its
  real block is this inverse.  float32 throughout, as the JAX family
  weights are float32 even under x64.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import score as score_mod
from . import stats
from .device import resolve_device, set_precision, sync
from .io.fasta import MSA
from .meanfield import MeanFieldDCA, _gram_fi, _pair_blocks
from .ops.cuda_kernels import identity_counts
from .ops.lbfgs import (
    LBFGSState,
    lbfgs_init,
    lbfgs_init_batch,
    lbfgs_steps,
    lbfgs_steps_batch,
)
from .plm import _expand_w4, _lse_q, _picked, init_params, plm_loss_and_grad
from .profiling import StageTimers

__all__ = [
    "BatchRun",
    "FamilyBatch",
    "FamilyFit",
    "LOCKSTEP_MAX_BYTES",
    "LockstepBatch",
    "lockstep_lane_bytes",
    "family_sequence_weights",
    "family_plm_fit",
    "family_plm_scores",
    "family_meanfield_scores",
    "bucket_families",
    "padded_flop_stats",
    "family_plm_fit_bucketed",
]

# Memory budget of one lock-step batch: the float32 bytes its lanes hold at
# the batch's (Nb, Lb), as ``lockstep_lane_bytes`` counts them.  A bucket
# that would pass it runs as consecutive sub-batches, and a family alone
# runs even above it.
LOCKSTEP_MAX_BYTES = 16 << 30


def lockstep_lane_bytes(nb: int, lb: int, q: int, m: int = 5) -> int:
    """What one lane of a lock-step batch at ``(nb, lb)`` holds, in float32
    bytes: the optimizer's ``2m + 7`` vectors of D = Lb q + Lb(Lb-1)/2 q^2
    (x, g, the 2m history rows, the direction, the best and the current
    trial's x and g), five (Nb, Lb q) tensors of one evaluation (the one-hot,
    the logits and what autograd keeps of the softmax) and four
    (Lb q)^2 ones (the expanded couplings, the logits operand and their
    cotangents)."""
    dim = lb * q + lb * (lb - 1) // 2 * q * q
    return 4 * ((2 * m + 7) * dim + 5 * nb * lb * q + 4 * (lb * q) ** 2)


class LockstepBatch(NamedTuple):
    """One lock-step fit of several families: its lanes, the padded
    ``(Nb, Lb)`` they share, the host wall of the fit (its set-up, init and
    loop, ending in a device synchronise), the host reads it made (one a
    round, whatever the lane count) and the lane-iterations it ran (over
    the loop's iterations, the lanes that ran each)."""

    lanes: int
    shape: Tuple[int, int]
    seconds: float
    host_syncs: int
    lane_iterations: int


# progress_fn(index, state, batch): called after each family's fit with its
# index in the caller's order, its final generic state (the family's own
# layout) and the LockstepBatch it ran in (the same object for every
# family of that batch)
ProgressFn = Callable[[int, LBFGSState, LockstepBatch], None]


class FamilyFit(NamedTuple):
    """One family's fit as a batch run reports it: its own iterations and
    evaluations and the index of its lock-step batch in
    ``BatchRun.batches``."""

    num_iters: int
    n_evals: int
    batch: int


class BatchRun(NamedTuple):
    """What a ``compute_fn_batch`` run returns: the files it wrote, each
    family's fit in input order and the lock-step batches in the order they
    ran (both empty for mean-field), and its stage timers.  The batches'
    seconds sum to the fit wall; their host syncs are the run's."""

    paths: List[str]
    fits: List[FamilyFit]
    batches: List[LockstepBatch]
    timers: StageTimers


class FamilyBatch:
    """A set of same-biomolecule MSAs padded to a common (F, Nmax, Lmax).

    ``data`` holds the pad token ``q`` outside each family's rows and
    sites; ``seq_mask`` (F, Nmax) and ``site_mask`` (F, Lmax) mark the real
    ones.  ``pad_to=(nmax, lmax)`` pads to the given bounds instead of the
    batch maxima; the fits run at the batch maxima whatever it is, and
    :func:`family_plm_fit` places its parameters at ``lmax``.
    """

    def __init__(self, msas: Sequence[MSA], pad_to: Optional[Tuple[int, int]] = None):
        if not msas:
            raise ValueError("empty family batch")
        qs = {m.q for m in msas}
        if len(qs) != 1:
            raise ValueError("all families must share one biomolecule/alphabet")
        self.msas: List[MSA] = list(msas)
        self.q: int = qs.pop()
        self.num_families = len(msas)
        self.lengths = np.array([m.seqs_len for m in msas], np.int32)
        self.nseqs = np.array([m.num_seqs for m in msas], np.int32)
        lmax = int(self.lengths.max())
        nmax = int(self.nseqs.max())
        if pad_to is not None:
            if pad_to[0] < nmax or pad_to[1] < lmax:
                raise ValueError(
                    f"pad_to {pad_to} smaller than batch maxima ({nmax}, {lmax})"
                )
            nmax, lmax = int(pad_to[0]), int(pad_to[1])
        data = np.full((len(msas), nmax, lmax), self.q, np.int32)  # pad token q
        for f, m in enumerate(msas):
            data[f, : m.num_seqs, : m.seqs_len] = m.data
        self.data = data
        self.seq_mask = np.arange(nmax)[None, :] < self.nseqs[:, None]  # (F, Nmax)
        self.site_mask = np.arange(lmax)[None, :] < self.lengths[:, None]  # (F, Lmax)

    @property
    def lmax(self) -> int:
        return self.data.shape[2]

    @property
    def nmax(self) -> int:
        return self.data.shape[1]


def _family_codes(batch: FamilyBatch, f: int, device) -> torch.Tensor:
    """Family ``f``'s own (N_f, L_f) int8 codes on ``device``: the padded
    block sliced first, so the pad token never reaches a kernel."""
    n, l = int(batch.nseqs[f]), int(batch.lengths[f])
    return _msa_codes(batch.data[f, :n, :l], device)


def _msa_codes(data: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(data, dtype=np.int8)).to(device)


def _weights_of(codes: torch.Tensor, seqid: float, q: int) -> torch.Tensor:
    """(N_f,) float32 weights ``1 / max(count, 1)`` of one family, the
    counts against ``float32(seqid * L_f)`` (``pydca_tpu/family.py:127-134``)."""
    counts = identity_counts(codes, float(np.float32(seqid * codes.shape[1])), q)
    return 1.0 / torch.clamp_min(counts, 1).to(torch.float32)


def family_sequence_weights(batch: FamilyBatch, seqid: float = 0.8, *, device) -> torch.Tensor:
    """(F, Nmax) float32 reweighting on ``device``, zero on pad rows."""
    dev = resolve_device(device)
    out = torch.zeros((batch.num_families, batch.nmax), dtype=torch.float32, device=dev)
    for f in range(batch.num_families):
        codes = _family_codes(batch, f, dev)
        out[f, : codes.shape[0]] = _weights_of(codes, seqid, batch.q)
    return out


def _lambdas(batch: FamilyBatch, given) -> np.ndarray:
    """Per-family float32 regularization; default ``0.2 (L_f - 1)``
    (``pydca/plmdca/plmdca.py:64-68``)."""
    if given is None:
        return np.asarray(0.2 * (batch.lengths - 1), np.float32)
    return np.broadcast_to(np.asarray(given, np.float32), (batch.num_families,))


def _fit_one(codes, weights, lambda_h, lambda_j, l: int, q: int, *,
             max_iterations: int, m: int = 5) -> LBFGSState:
    """One family's fit: the generic loop over the full-batch objective
    (:func:`~pydca_tpu_torch.plm.plm_loss_and_grad`) from the reference
    init, at the family's own shape.  The per-family reference the
    lock-step fit is held to (tests, ``chip_smoke.py``); no run path calls
    it."""
    fun = functools.partial(plm_loss_and_grad, msa=codes, weights=weights,
                            lambda_h=float(lambda_h), lambda_j=float(lambda_j), l=l, q=q)
    st = lbfgs_init(fun, init_params(codes, weights, l, q), m=m)
    return lbfgs_steps(fun, st, max_iterations)


def _family_pair_select(l_f: int, lmax: int) -> np.ndarray:
    """Indices into the Lmax pair order for the pairs within the first l_f sites."""
    iu, ju = np.triu_indices(l_f, k=1)
    return np.asarray(stats.pair_index(iu, ju, lmax), np.int64)


def _own_index(l: int, lb: int, q: int) -> torch.Tensor:
    """Positions in the reference layout at ``lb`` of a family's own
    parameters at ``l`` (fields site-major, then its pairs' q x q blocks)."""
    pairs = lb * q + _family_pair_select(l, lb)[:, None] * (q * q) + np.arange(q * q)
    return torch.from_numpy(np.concatenate([np.arange(l * q), pairs.reshape(-1)]))


def _lanes_loss_and_grad(theta, codes, weights, site_mask, lambda_h, lambda_j, l: int, q: int):
    """Each lane's masked pseudolikelihood (``pydca_tpu/family.py:142-166``)
    and its gradient over a ``(F, Nb, Lb)`` block: ``theta`` (F, D) at
    ``l = Lb``, ``codes`` (F, Nb, Lb) with the pad token ``q`` (an all-zero
    one-hot row), ``weights`` (F, Nb) zero on pad rows, ``site_mask`` (F, Lb)
    and per-lane ``lambda_h``, ``lambda_j`` (F,).  Returns ``(loss (F,),
    grad (F, D))``; the lanes are independent, so the gradient of their sum
    is each lane's own."""
    nl, n = codes.shape[:2]
    states = torch.arange(q, device=codes.device, dtype=codes.dtype)
    theta = theta.detach().requires_grad_(True)
    with torch.enable_grad():
        x = (codes[..., None] == states).to(theta.dtype).reshape(nl, n, l * q)
        maskq = codes.reshape(nl * n, 1, l) == states[:, None]  # (F Nb, q, Lb)
        h = theta[:, : l * q].reshape(nl, l, q)
        j = theta[:, l * q :]
        logits = torch.bmm(x, _expand_w4(j, l, q)).reshape(nl, n, q, l)
        logits = (logits + h.transpose(1, 2)[:, None]).reshape(nl * n, q, l)
        per_site = (_lse_q(logits) - _picked(logits, maskq)).reshape(nl, n, l)
        per_site = per_site * site_mask[:, None, :]
        nll = (weights[:, :, None] * per_site).sum(dim=(1, 2))
        loss = nll + lambda_h * (h * h).sum(dim=(1, 2)) + lambda_j * (j * j).sum(dim=1)
        (grad,) = torch.autograd.grad(loss.sum(), theta)
    return loss.detach(), grad


def _lockstep_problem(codes, weights, lambda_h, lambda_j, q: int):
    """The lock-step objective of families with their own (N_f, L_f) int8
    ``codes`` and (N_f,) ``weights`` on one device and float32
    ``lambda_h``/``lambda_j`` arrays a family: ``(fun, x0, places)``, with
    ``fun(x, lanes)`` :func:`_lanes_loss_and_grad` over the block of the
    given lanes at the batch maxima ``(Nb, Lb)``, ``x0`` (F, D) every
    lane's reference init in the ``Lb`` layout, pad entries 0, and
    ``places[f]`` the positions of family ``f``'s own parameters in it."""
    dev = codes[0].device
    nl = len(codes)
    nb = max(c.shape[0] for c in codes)
    lb = max(c.shape[1] for c in codes)
    block = torch.full((nl, nb, lb), q, dtype=torch.int8, device=dev)
    wblock = torch.zeros((nl, nb), dtype=torch.float32, device=dev)
    site_mask = torch.zeros((nl, lb), dtype=torch.float32, device=dev)
    x0 = torch.zeros((nl, lb * q + lb * (lb - 1) // 2 * q * q), dtype=torch.float32,
                     device=dev)
    places = []
    for f, (c, w) in enumerate(zip(codes, weights)):
        n, l = c.shape
        block[f, :n, :l] = c
        wblock[f, :n] = w
        site_mask[f, :l] = 1.0
        places.append(_own_index(l, lb, q).to(dev))
        x0[f, places[-1]] = init_params(c, w, l, q)
    lam_h = torch.as_tensor(np.asarray(lambda_h, np.float32), device=dev)
    lam_j = torch.as_tensor(np.asarray(lambda_j, np.float32), device=dev)

    def fun(x, lanes):
        if len(lanes) == nl:  # every lane, in order
            return _lanes_loss_and_grad(x, block, wblock, site_mask, lam_h, lam_j, lb, q)
        return _lanes_loss_and_grad(x, block[lanes], wblock[lanes], site_mask[lanes],
                                    lam_h[lanes], lam_j[lanes], lb, q)

    return fun, x0, places


def _fit_lockstep(codes, weights, lambda_h, lambda_j, q: int, *, max_iterations: int,
                  m: int = 5):
    """Fit the families of one lock-step batch (the arguments of
    :func:`_lockstep_problem`).  Returns ``(states, batch)``: each family's
    final generic state in its own layout (the iterate, gradient and
    history rows cut from the ``Lb`` layout, exactly: every pad entry is 0)
    and the :class:`LockstepBatch`."""
    t0 = time.perf_counter()
    fun, x0, places = _lockstep_problem(codes, weights, lambda_h, lambda_j, q)
    shape = (max(c.shape[0] for c in codes), max(c.shape[1] for c in codes))
    st = lbfgs_init_batch(fun, x0, m=m)
    lbfgs_steps_batch(fun, st, max_iterations)
    states = []
    for f, idx in enumerate(places):
        lane = st.lane(f)
        states.append(dataclasses.replace(lane, x=lane.x[idx], g=lane.g[idx], z=lane.z[:, idx]))
    syncs, lane_iterations = st.host_syncs, st.lane_iterations
    del st
    sync(codes[0].device)
    return states, LockstepBatch(len(codes), shape, time.perf_counter() - t0, syncs,
                                 lane_iterations)


def _lockstep_groups(shapes: Sequence[Tuple[int, int]], q: int, m: int = 5) -> List[List[int]]:
    """Split families (their (N_f, L_f) in order) into consecutive
    lock-step batches whose lanes stay within ``LOCKSTEP_MAX_BYTES`` at
    their own maxima; a family alone is a batch whatever its size."""
    groups, cur, nb, lb = [], [], 0, 0
    for i, (n, l) in enumerate(shapes):
        nb2, lb2 = max(nb, n), max(lb, l)
        if cur and (len(cur) + 1) * lockstep_lane_bytes(nb2, lb2, q, m) > LOCKSTEP_MAX_BYTES:
            groups.append(cur)
            cur, nb2, lb2 = [], n, l
        cur.append(i)
        nb, lb = nb2, lb2
    groups.append(cur)
    return groups


def family_plm_fit(
    batch: FamilyBatch,
    *,
    seqid: float = 0.8,
    lambda_h: Optional[np.ndarray] = None,
    lambda_j: Optional[np.ndarray] = None,
    max_iterations: int = 100,
    m: int = 5,
    weights: Optional[torch.Tensor] = None,
    device,
    progress_fn: Optional[ProgressFn] = None,
):
    """Fit every family of the batch in lock-step; returns ``(thetas
    (F, D_max), states)``.

    ``thetas`` is a host tensor with each family's parameters in the
    reference layout at ``Lmax`` (fields site-major, couplings in the Lmax
    pair order), every pad entry exactly 0; ``states`` are the per-family
    generic states in each family's own layout, moved to the host.  One
    lock-step batch at the batch maxima, split only by
    ``LOCKSTEP_MAX_BYTES``.  Regularization defaults to ``0.2 (L_f - 1)``
    per family.  ``progress_fn`` gets each family's index when its batch
    ends.
    """
    dev = resolve_device(device)
    set_precision()
    if weights is None:
        weights = family_sequence_weights(batch, seqid, device=dev)
    lam_h, lam_j = _lambdas(batch, lambda_h), _lambdas(batch, lambda_j)
    lmax, q = batch.lmax, batch.q
    thetas = torch.zeros((batch.num_families, lmax * q + lmax * (lmax - 1) // 2 * q * q),
                         dtype=torch.float32)
    states = [None] * batch.num_families
    shapes = list(zip(batch.nseqs.tolist(), batch.lengths.tolist()))
    for group in _lockstep_groups(shapes, q, m):
        codes = [_family_codes(batch, f, dev) for f in group]
        ws = [weights[f, : shapes[f][0]].to(dev) for f in group]
        fits, run = _fit_lockstep(codes, ws, lam_h[group], lam_j[group], q,
                                  max_iterations=max_iterations, m=m)
        for f, st in zip(group, fits):
            st = dataclasses.replace(st, x=st.x.cpu(), g=st.g.cpu(), z=st.z.cpu())
            l = shapes[f][1]
            thetas[f, : l * q] = st.x[: l * q]
            sel = torch.from_numpy(_family_pair_select(l, lmax))
            thetas[f, lmax * q :].view(-1, q * q)[sel] = st.x[l * q :].view(-1, q * q)
            states[f] = st
            if progress_fn is not None:
                progress_fn(f, st, run)
        del codes, ws, fits
    return thetas, states


def _sorted_fn(blocks: torch.Tensor, l: int, apc: bool):
    fn = score_mod.frobenius_norms(blocks)
    if apc:
        fn = score_mod.apc(fn, l)
    return score_mod.sorted_scores(fn, l)


def _own_scores(x: torch.Tensor, l: int, q: int, apc: bool):
    """Sorted FN(-APC) of one family's own (unpadded) parameters."""
    return _sorted_fn(x[l * q :].view(-1, q, q)[:, : q - 1, : q - 1], l, apc)


def family_plm_scores(batch: FamilyBatch, thetas: torch.Tensor, *, apc: bool = True):
    """Per-family sorted FN(-APC) score lists from the padded parameters."""
    lmax, q = batch.lmax, batch.q
    out = []
    for f, l_f in enumerate(batch.lengths):
        l_f = int(l_f)
        sel = torch.from_numpy(_family_pair_select(l_f, lmax)).to(thetas.device)
        blocks = thetas[f, lmax * q :].view(-1, q, q)[sel][:, : q - 1, : q - 1]
        out.append(_sorted_fn(blocks, l_f, apc))
    return out


def _family_mf_couplings(codes, weights, pseudocount: float, l: int, q: int) -> torch.Tensor:
    """One family's mean-field couplings ``-C^{-1}``, (L(q-1), L(q-1)), in
    the weights' dtype: the Gram, ``C`` in place and the SPD inverse (an LU
    inverse when the factor fails, as the engine does)."""
    gram = stats.weighted_gram(codes, weights, q)
    fi_reg = stats.regularize_fi(_gram_fi(gram, l, q), q, pseudocount)
    c = stats.corr_mat_from_gram(gram, fi_reg, pseudocount, l, q)
    del gram
    return MeanFieldDCA._inverse_with_fallback(c)


def family_meanfield_scores(
    batch: FamilyBatch,
    *,
    seqid: float = 0.8,
    pseudocount: float = 0.5,
    apc: bool = True,
    device,
):
    """Mean-field FN(-APC) score lists of every family."""
    dev = resolve_device(device)
    set_precision()
    weights = family_sequence_weights(batch, seqid, device=dev)
    q = batch.q
    out = []
    for f in range(batch.num_families):
        codes = _family_codes(batch, f, dev)
        n, l = codes.shape
        couplings = _family_mf_couplings(codes, weights[f, :n], pseudocount, l, q)
        out.append(_sorted_fn(_pair_blocks(couplings, l, q - 1), l, apc))
        del couplings
    return out


# ------------------------------------------------------------- bucketed batch
def _pow2_at_least(x: int, floor: int) -> int:
    n = max(int(x), floor)
    return 1 << (n - 1).bit_length()


def bucket_families(msas: Sequence[MSA], *, min_n: int = 64, min_l: int = 16):
    """Group family indices into (N, L) power-of-two buckets:
    ``{(n_bound, l_bound): [original indices]}`` (``pydca_tpu/family.py:328-350``).
    :func:`family_plm_fit_bucketed` fits each bucket in lock-step, at the
    bucket's own maxima, not at its power-of-two key."""
    groups = {}
    for idx, m in enumerate(msas):
        key = (_pow2_at_least(m.num_seqs, min_n), _pow2_at_least(m.seqs_len, min_l))
        groups.setdefault(key, []).append(idx)
    return groups


def padded_flop_stats(msas: Sequence[MSA], groups=None) -> dict:
    """The JAX package's padded-vs-useful FLOP accounting of the plm data
    term, ``N * (L*q)^2`` per family and evaluation
    (``pydca_tpu/family.py:353-380``).  Its buckets are padded to their own
    maxima, as the port's lock-step batches are (unless
    ``LOCKSTEP_MAX_BYTES`` splits one)."""
    q = msas[0].q
    cost = lambda n, l: float(n) * (float(l) * q) ** 2
    useful = sum(cost(m.num_seqs, m.seqs_len) for m in msas)
    nmax = max(m.num_seqs for m in msas)
    lmax = max(m.seqs_len for m in msas)
    single = len(msas) * cost(nmax, lmax)
    if groups is None:
        groups = bucket_families(msas)
    bucketed = 0.0
    for idxs in groups.values():
        nb = max(msas[i].num_seqs for i in idxs)
        lb = max(msas[i].seqs_len for i in idxs)
        bucketed += len(idxs) * cost(nb, lb)
    return {
        "useful_flops": useful,
        "single_block_flops": single,
        "bucketed_flops": bucketed,
        "single_block_waste": single / useful,
        "bucketed_waste": bucketed / useful,
    }


def family_plm_fit_bucketed(
    msas: Sequence[MSA],
    *,
    seqid: float = 0.8,
    max_iterations: int = 100,
    apc: bool = True,
    min_n: int = 64,
    min_l: int = 16,
    device,
    progress_fn: Optional[ProgressFn] = None,
):
    """Fit and score many heterogeneous families, one lock-step batch per
    (N, L) bucket (``pydca_tpu/family.py:383-410``); returns
    ``(scores_per_family, stats)`` with the scores in input order (FN-APC
    by default) and :func:`padded_flop_stats` of the buckets plus
    ``num_buckets``.  The buckets run in the JAX package's order, each
    family in input order inside its bucket, split only by
    ``LOCKSTEP_MAX_BYTES``.  Each family is scored from its own parameters
    as soon as its batch ends, after which the batch is dropped.
    ``progress_fn`` gets each family's index in ``msas``."""
    groups = bucket_families(msas, min_n=min_n, min_l=min_l)
    dev = resolve_device(device)
    set_precision()
    scores: List = [None] * len(msas)
    for key in sorted(groups):
        idxs = groups[key]
        q = msas[idxs[0]].q
        shapes = [(msas[i].num_seqs, msas[i].seqs_len) for i in idxs]
        for part in _lockstep_groups(shapes, q):
            fams = [idxs[j] for j in part]
            codes = [_msa_codes(msas[i].data, dev) for i in fams]
            weights = [_weights_of(c, seqid, q) for c in codes]
            lam = np.asarray([0.2 * (msas[i].seqs_len - 1) for i in fams], np.float32)
            fits, run = _fit_lockstep(codes, weights, lam, lam, q,
                                      max_iterations=max_iterations)
            for i, st in zip(fams, fits):
                if progress_fn is not None:
                    progress_fn(i, st, run)
                scores[i] = _own_scores(st.x, msas[i].seqs_len, q, apc)
            del fits, codes, weights
    stats_d = padded_flop_stats(msas, groups)
    stats_d["num_buckets"] = len(groups)
    return scores, stats_d
