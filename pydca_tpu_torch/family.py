"""Family batches: many MSAs of one biomolecule in one call, in PyTorch.

Port of ``pydca_tpu/family.py``.  The JAX package pads the families to one
``(F, Nmax, Lmax)`` block and ``vmap``s the pipeline over the family axis.
The port keeps :class:`FamilyBatch` as that padded host layout (the API
and the tests use it), but runs each family at its own ``(N_f, L_f)``, one
after another on one device, on the family's own rows and sites (the pad
token ``q`` never reaches a kernel):

- weights: the identity counts of each family (the CUDA ``identity_counts``
  kernel on a card, once per family) against ``float32(seqid * L_f)``,
  weights ``1 / max(count, 1)`` as the JAX family path has them
  (``family.py:127``; the single-family weights are ``1 / count``, which
  differs at ``seqid = 1.0``), zero on pad rows;
- plmDCA: the generic L-BFGS loop over the full-batch objective, as
  ``_family_fit_impl`` runs it, from the reference init with
  ``lambda = 0.2 (L_f - 1)``.  This is the vmapped padded fit's math: pad
  rows have weight 0 and pad sites are masked, so they add nothing to the
  loss or the gradient; pad fields start at ``log(0 * Meff + 1) = 0`` and
  the L2 term keeps a zero at zero, so every dot product of the loop is the
  same.  :func:`family_plm_fit` returns the parameters padded into the
  reference layout at ``Lmax`` on the host, every pad entry exactly 0, for
  the API and the tests; the batch CLI's :func:`family_plm_fit_bucketed`
  scores each family from its own parameters as soon as its fit ends and
  drops them, so the device holds one family at a time;
- mean-field: the weighted Gram (the CUDA ``weighted_gram`` kernel), ``C``
  and its SPD inverse per family: JAX's identity rows on pad sites make its
  inverse block-diagonal, and its real block is this inverse.  float32
  throughout, as the JAX family weights are float32 even under x64.

A lock-step batched loop across families (the GPU's answer to ``vmap``)
would need a batched line search; it is not written.
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
from .ops.lbfgs import LBFGSState, lbfgs_init, lbfgs_steps
from .plm import init_params, plm_loss_and_grad
from .profiling import StageTimers

__all__ = [
    "BatchRun",
    "FamilyBatch",
    "FamilyFit",
    "family_sequence_weights",
    "family_plm_fit",
    "family_plm_scores",
    "family_meanfield_scores",
    "bucket_families",
    "padded_flop_stats",
    "family_plm_fit_bucketed",
]

# progress_fn(index, state, seconds): called after each family's fit with
# its index in the caller's order, its final generic state and the host
# wall of the fit (ending in a device synchronise)
ProgressFn = Callable[[int, LBFGSState, float], None]


class FamilyFit(NamedTuple):
    """One family's fit as a batch run reports it."""

    num_iters: int
    n_evals: int
    host_syncs: int
    seconds: float


class BatchRun(NamedTuple):
    """What a ``compute_fn_batch`` run returns: the files it wrote, each
    family's fit in input order (empty for mean-field) and its stage
    timers."""

    paths: List[str]
    fits: List[FamilyFit]
    timers: StageTimers


class FamilyBatch:
    """A set of same-biomolecule MSAs padded to a common (F, Nmax, Lmax).

    ``data`` holds the pad token ``q`` outside each family's rows and
    sites; ``seq_mask`` (F, Nmax) and ``site_mask`` (F, Lmax) mark the real
    ones.  ``pad_to=(nmax, lmax)`` pads to the given bounds instead of the
    batch maxima (the bucketed run's power-of-two bounds).
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
    init, at the family's own shape."""
    fun = functools.partial(plm_loss_and_grad, msa=codes, weights=weights,
                            lambda_h=float(lambda_h), lambda_j=float(lambda_j), l=l, q=q)
    st = lbfgs_init(fun, init_params(codes, weights, l, q), m=m)
    return lbfgs_steps(fun, st, max_iterations)


def _family_pair_select(l_f: int, lmax: int) -> np.ndarray:
    """Indices into the Lmax pair order for the pairs within the first l_f sites."""
    iu, ju = np.triu_indices(l_f, k=1)
    return np.asarray(stats.pair_index(iu, ju, lmax), np.int64)


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
):
    """Fit every family; returns ``(thetas (F, D_max), states)``.

    ``thetas`` is a host tensor with each family's parameters in the
    reference layout at ``Lmax`` (fields site-major, couplings in the Lmax
    pair order), every pad entry exactly 0; ``states`` are the per-family
    generic states, moved to the host, so the device holds one family's fit
    at a time.  Regularization defaults to ``0.2 (L_f - 1)`` per family.
    """
    dev = resolve_device(device)
    set_precision()
    if weights is None:
        weights = family_sequence_weights(batch, seqid, device=dev)
    lam_h, lam_j = _lambdas(batch, lambda_h), _lambdas(batch, lambda_j)
    lmax, q = batch.lmax, batch.q
    thetas = torch.zeros((batch.num_families, lmax * q + lmax * (lmax - 1) // 2 * q * q),
                         dtype=torch.float32)
    states = []
    for f in range(batch.num_families):
        codes = _family_codes(batch, f, dev)
        n, l = codes.shape
        st = _fit_one(codes, weights[f, :n].to(dev), lam_h[f], lam_j[f], l, q,
                      max_iterations=max_iterations, m=m)
        st = dataclasses.replace(st, x=st.x.cpu(), g=st.g.cpu(), z=st.z.cpu())
        thetas[f, : l * q] = st.x[: l * q]
        sel = torch.from_numpy(_family_pair_select(l, lmax))
        thetas[f, lmax * q :].view(-1, q * q)[sel] = st.x[l * q :].view(-1, q * q)
        states.append(st)
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
    The port fits every family at its own shape: the buckets only feed
    :func:`padded_flop_stats`."""
    groups = {}
    for idx, m in enumerate(msas):
        key = (_pow2_at_least(m.num_seqs, min_n), _pow2_at_least(m.seqs_len, min_l))
        groups.setdefault(key, []).append(idx)
    return groups


def padded_flop_stats(msas: Sequence[MSA], groups=None) -> dict:
    """The JAX package's padded-vs-useful FLOP accounting of the plm data
    term, ``N * (L*q)^2`` per family and evaluation
    (``pydca_tpu/family.py:353-380``).  It describes the padded ``vmap``;
    the port does only the useful work."""
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
    """Fit and score many heterogeneous families; returns
    ``(scores_per_family, stats)`` with the scores in input order (FN-APC
    by default) and :func:`padded_flop_stats` of the (N, L) buckets plus
    ``num_buckets``.  The port never pads, so the buckets only feed the
    stats: each family is fitted at its own shape, in input order, and
    scored from its own parameters as soon as its fit ends, after which its
    state is dropped.  ``progress_fn`` gets each family's index in ``msas``."""
    groups = bucket_families(msas, min_n=min_n, min_l=min_l)
    dev = resolve_device(device)
    set_precision()
    scores = []
    for f, msa in enumerate(msas):
        codes = _msa_codes(msa.data, dev)
        l, q = msa.seqs_len, msa.q
        lam = np.float32(0.2 * (l - 1))
        weights = _weights_of(codes, seqid, q)
        t0 = time.perf_counter()
        st = _fit_one(codes, weights, lam, lam, l, q, max_iterations=max_iterations)
        sync(dev)
        if progress_fn is not None:
            progress_fn(f, st, time.perf_counter() - t0)
        scores.append(_own_scores(st.x, l, q, apc))
        del st, codes, weights
    stats_d = padded_flop_stats(msas, groups)
    stats_d["num_buckets"] = len(groups)
    return scores, stats_d
