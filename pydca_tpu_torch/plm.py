"""Pseudolikelihood-maximization DCA (plmDCA) in PyTorch.

Port of ``pydca_tpu/plm.py``: the objective, the fused direction-space
L-BFGS loop (``_plm_fused_state0`` / ``_plm_fused_steps``) for alignments
whose logits fit, the streamed objective over sequence blocks with the
generic L-BFGS loop (``plm_loss_and_grad_chunked`` / ``_plm_lbfgs_state0``
/ ``_plm_lbfgs_steps``) for deep ones, ``fit_plm`` over both (on one
device, or over the ranks of a mesh with the sequences sharded:
``fit_plm(mesh=...)``), and the :class:`PlmDCA` engine's FN and DI scoring
and parameter extraction.  The math is the JAX package's; its TPU compile
workarounds are not ported:

- the parameter vector is one flat float32 tensor of length
  ``D = L*q + P*q*q`` in the reference layout (fields site-major, then
  couplings pair-major; ``plmdca_numerics.cpp:319-365``), not a split
  (h, J) pair;
- the L-BFGS history is one ``(2m, D)`` tensor whose rows are written in
  place (rows 0..m-1 = S, m..2m-1 = Y), not 2m leaves behind a switch;
- the logits operand is the plain 2-D ``(L*q, q*L)`` coupling matrix and
  both logits products are library GEMMs (:func:`_mm`); logits keep the
  ``(N, q, L)`` layout;
- the streamed objective takes the (N, L) alignment and a block size
  instead of zero-weight padded ``(nb, block, L)`` blocks: the last block
  may be short.

``precision="bfloat16"`` (``mm_bf16``), with the JAX package's meaning:
both logits products take bfloat16 operands (the cotangent of the backward
one included) and accumulate and return float32 (:func:`resolve_precision`,
:func:`_mm`); the default is float32.  The fit has one parameter space,
the compact reference layout: ``param_space`` is accepted for the JAX
package's interface, and its ``"w2"`` fits the same layout
(:func:`_check_param_space`).

Checkpoints (``fit_plm(checkpoint_path=...)``) are the JAX package's npz
files, key for key (``_save_state`` / ``_load_state``): either package
resumes the other's compact file, with the history dtype the file holds,
and a failed chunk is retried at most twice from the file.

The fused loop's structure is the JAX package's (see the note above
``pydca_tpu/plm.py::_plm_fused_steps``): logits are linear along a search
direction, so a line-search trial is one elementwise pass over the
carried logits, and the L-BFGS direction needs only the cached history
projections ``zg = Z @ g`` and Gram ``zzt = Z @ Z.T``.  The scalar
decisions (direction coefficients, strong-Wolfe search, history Gram
update, convergence) run on the host in float32; each is fed by one
device-to-host read of a few scalars, counted in ``host_syncs``.
"""

from __future__ import annotations

import functools
import logging
import os
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from . import score as score_mod
from . import stats
from .device import resolve_device, set_precision, sync
from .io.fasta import MSA, read_msa
from .ops.cuda_kernels import plm_trial, plm_update_grad
from .ops.lbfgs import (
    LBFGSResult,
    LBFGSState,
    direction_coeffs,
    fetch_f32,
    gradient_converged,
    lbfgs_init,
    lbfgs_steps,
    result_from_state,
    wolfe_scalar,
)
from .parallel.mesh import resolve_mesh, shard_msa
from .profiling import StageTimers, span

logger = logging.getLogger(__name__)

__all__ = [
    "PlmDCA",
    "PlmDCAException",
    "PlmFusedState",
    "fit_plm",
    "fit_seq_block",
    "fused_state_from_numpy",
    "init_params",
    "lbfgs_state_from_numpy",
    "plm_loss",
    "plm_loss_and_grad",
    "plm_loss_and_grad_chunked",
    "resolve_precision",
    "streaming_block",
]

_F32 = np.float32

# The engine streams the loss over sequence blocks when the per-evaluation
# logits tensor (N * L * q float32) would exceed 1 GiB, with the JAX
# engine's threshold and block size (pydca_tpu/plm.py:1566-1573).
STREAMING_LOGITS_BYTES = 1 << 30


def streaming_block(n: int, l: int, q: int) -> Optional[int]:
    """The sequence block the engine streams with by itself: ``None`` while
    the (N, q, L) float32 logits fit in ``STREAMING_LOGITS_BYTES``, else
    ``max(1024, int(2**30 / (4 * L * q)))`` sequences."""
    if 4 * n * l * q <= STREAMING_LOGITS_BYTES:
        return None
    return max(1024, int(STREAMING_LOGITS_BYTES / (4 * l * q)))


def fit_seq_block(n: int, l: int, q: int, mesh=None) -> Optional[int]:
    """The sequence block the engine's fit of an N-row alignment streams
    with by itself: :func:`streaming_block` of the rows one card holds.
    That is N on one device, and under a mesh the stripe
    ``ceil(N / data axis)`` (pads included), the same on every rank, so
    the ranks take one route and their collectives match."""
    if mesh is not None:
        _, start, stop = mesh.stripe_rows(n)
        n = stop - start
    return streaming_block(n, l, q)


class PlmDCAException(Exception):
    """Errors specific to the plmDCA engine."""


def resolve_precision(precision) -> bool:
    """Map a user-facing precision name to the ``mm_bf16`` flag:
    ``None``/``"auto"``/``"float32"``/``"f32"`` -> False (float32, the JAX
    package's default off a TPU, ``pydca_tpu/plm.py:65-79``);
    ``"bfloat16"``/``"bf16"`` -> True; anything else raises."""
    if precision in ("bfloat16", "bf16"):
        return True
    if precision in (None, "auto", "float32", "f32"):
        return False
    raise PlmDCAException(
        f"invalid precision {precision!r}; choose auto, bfloat16 or float32"
    )


# --------------------------------------------------------------- loss function
class _PairPlan(NamedTuple):
    """Device-resident index maps between the flat pair layout and the
    full (L, L, q, q) coupling tensor (built once per (L, device))."""

    pidx: torch.Tensor  # (L*L,) pair index of (min(i,j), max(i,j)); 0 on diag
    ij_rows: torch.Tensor  # (P,) row i*L+j of each pair i < j
    ji_rows: torch.Tensor  # (P,) row j*L+i of each pair i < j
    lower: torch.Tensor  # (L, L, 1, 1) bool, i > j
    diag: torch.Tensor  # (L, L, 1, 1) bool, i == j


@functools.lru_cache(maxsize=8)
def _pair_plan(l: int, device: torch.device) -> _PairPlan:
    iu, ju = np.triu_indices(l, k=1)
    ii = np.arange(l)[:, None, None, None]
    jj = np.arange(l)[None, :, None, None]
    return _PairPlan(
        pidx=torch.from_numpy(stats.pair_index_matrix(l).reshape(-1).astype(np.int64)).to(device),
        ij_rows=torch.from_numpy((iu * l + ju).astype(np.int64)).to(device),
        ji_rows=torch.from_numpy((ju * l + iu).astype(np.int64)).to(device),
        lower=torch.from_numpy(ii > jj).to(device),
        diag=torch.from_numpy(ii == jj).to(device),
    )


def _one_hot(msa: torch.Tensor, l: int, q: int, dtype=torch.float32) -> torch.Tensor:
    """One-hot ``(N, L*q)`` of the codes (column ``j*q + b``)."""
    return torch.nn.functional.one_hot(msa.long(), q).to(dtype).reshape(msa.shape[0], l * q)


def _pick_mask(codes: torch.Tensor, q: int) -> torch.Tensor:
    """``(N, q, L)`` bool, ``codes[n, i] == a``: the observed state of each
    site of the ``(N, L)`` codes; a code outside ``[0, q)`` picks none."""
    return codes.long()[:, None, :] == torch.arange(q, device=codes.device)[None, :, None]


def _prep_msa(msa: torch.Tensor, l: int, q: int, dtype=torch.float32):
    """One-hot ``(N, L*q)`` (column ``j*q + b``) and per-state pick mask
    ``(N, q, L)`` for the loss; computed once per fit."""
    return _one_hot(msa, l, q, dtype), _pick_mask(msa, q)


def _fused_inputs(msa: torch.Tensor, l: int, q: int, dtype=torch.float32):
    """The fused loop's one-hot ``(N, L*q)`` and ``(N, L)`` uint8 codes (the
    passes over the logits read the codes in place of a pick mask);
    computed once per fit."""
    return _one_hot(msa, l, q, dtype), msa.to(torch.uint8).contiguous()


def _expand_full(j_flat: torch.Tensor, l: int, q: int) -> torch.Tensor:
    """Flat (P*q*q,) couplings -> the full symmetric (L, L, q, q) tensor.

    ``J_full[i, j] = J_pair(i,j)`` for i < j, its transpose for i > j, zeros
    on the diagonal — the symmetric-variant storage the reference uses
    (``plmdca_numerics.cpp:501-517``).  Differentiable (autograd turns the
    gather into a scatter-add).  Leading axes of ``j_flat`` are lanes, each
    expanded on its own.
    """
    plan = _pair_plan(l, j_flat.device)
    lead = j_flat.shape[:-1]
    jg = j_flat.reshape(*lead, -1, q * q)[..., plan.pidx, :].reshape(*lead, l, l, q, q)
    jfull = torch.where(plan.lower, jg.transpose(-1, -2), jg)
    return torch.where(plan.diag, torch.zeros((), dtype=jfull.dtype, device=jfull.device), jfull)


def _expand_w4(j_flat: torch.Tensor, l: int, q: int) -> torch.Tensor:
    """Flat pair couplings -> the 2-D ``(L*q, q*L)`` logits operand ``W``
    with ``W[j*q + b, a*L + i] = J_full[i, j, a, b]``, so that
    ``logits[n, a, i] = sum_{j,b} x[n, j*q+b] W[j*q+b, a*L+i] + h[i, a]``
    (``pydca_tpu/plm.py:283-286``); one per lane of ``j_flat``'s leading
    axes."""
    full = _expand_full(j_flat, l, q)
    k = full.dim() - 4
    lead = tuple(range(k))
    return full.permute(*lead, k + 1, k + 3, k + 2, k).reshape(*full.shape[:k], l * q, q * l)


def _pair_pullback_rows(cr: torch.Tensor, l: int, q: int) -> torch.Tensor:
    """(L*L, q*q) rows in (i, j)-major order with (a, b)-contiguous content
    -> flat (P*q*q,) pair gradient: each pair (i < j) receives its own
    (i, j) block plus the transposed (j, i) block."""
    plan = _pair_plan(l, cr.device)
    d_ij = cr[plan.ij_rows].reshape(-1, q, q)
    d_ji = cr[plan.ji_rows].reshape(-1, q, q)
    return (d_ij + d_ji.transpose(-1, -2)).reshape(-1)


def _w4_cot_to_compact(gw: torch.Tensor, l: int, q: int) -> torch.Tensor:
    """Pull a ``(L*q, q*L)`` logits-operand cotangent (rows (j, b), columns
    (a, i)) back to the flat pair layout."""
    gj4 = gw.reshape(l, q, q, l).permute(3, 0, 2, 1)  # (i, j, a, b)
    return _pair_pullback_rows(gj4.reshape(l * l, q * q), l, q)


def _x_dtype(mm_bf16: bool) -> torch.dtype:
    """The one-hot's dtype: bfloat16 under bfloat16 products (0 and 1 are
    exact, so it is stored once per fit and never cast per evaluation),
    else float32."""
    return torch.bfloat16 if mm_bf16 else torch.float32


def _mm(a: torch.Tensor, b: torch.Tensor, mm_bf16: bool,
        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``a @ b`` in float32, added into ``out`` in place when it is given.

    ``mm_bf16``: both operands are rounded to bfloat16 and the products
    summed and returned in float32, as ``preferred_element_type=float32``
    gives in the JAX package (``pydca_tpu/plm.py:132-139``).  On a card
    that is one cuBLAS bfloat16 GEMM with a float32 output
    (``aten::mm.dtype`` / ``aten::addmm.dtype``); the CPU has no kernel for
    those, so it multiplies the rounded operands in float32, where the
    product of two bfloat16 values is exact."""
    with span("plm/mm"):
        if mm_bf16:
            a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
            if a.device.type == "cuda":
                if out is None:
                    return torch.mm(a, b, out_dtype=torch.float32)
                return torch.addmm(out, a, b, out_dtype=torch.float32, out=out)
            a, b = a.float(), b.float()
        return torch.mm(a, b) if out is None else out.addmm_(a, b)


class _LogitsMM(torch.autograd.Function):
    """``x @ W`` whose backward is ``x^T @ ct`` through :func:`_mm`: under
    bfloat16 products the cotangent is rounded to bfloat16 too, as the JAX
    package's custom VJP does (``pydca_tpu/plm.py:147-158``); torch's own
    transpose would keep it in float32."""

    @staticmethod
    def forward(ctx, x, w, mm_bf16):
        ctx.save_for_backward(x)
        ctx.mm_bf16 = mm_bf16
        return _mm(x, w, mm_bf16)

    @staticmethod
    def backward(ctx, ct):
        (x,) = ctx.saved_tensors
        return None, _mm(x.T, ct, ctx.mm_bf16), None


def _logits_mm(x: torch.Tensor, w: torch.Tensor, q: int, l: int,
               mm_bf16: bool = False) -> torch.Tensor:
    """Forward logits product ``(N, Lq) @ (Lq, qL)`` -> float32 ``(N, q, L)``."""
    return _LogitsMM.apply(x, w, mm_bf16).reshape(-1, q, l)


def _mm_b(x: torch.Tensor, ct: torch.Tensor, acc: Optional[torch.Tensor] = None,
          mm_bf16: bool = False) -> torch.Tensor:
    """Backward logits product: ``x^T @ ct`` contracting N -> float32
    ``(Lq, qL)`` (``pydca_tpu/plm.py:763`` ``_mm_b4``); added into ``acc``
    in place when it is given."""
    return _mm(x.T, ct.reshape(ct.shape[0], -1), mm_bf16, acc)


def _lse_q(logits: torch.Tensor) -> torch.Tensor:
    """Stable logsumexp over the middle (q) axis of ``(N, q, L)`` logits."""
    mx = logits.amax(dim=1).detach()
    return mx + torch.log(torch.exp(logits - mx[:, None, :]).sum(dim=1))


def _picked(logits: torch.Tensor, maskq: torch.Tensor) -> torch.Tensor:
    """Logit of each sequence's observed state, ``(N, L)``."""
    return torch.where(maskq, logits, torch.zeros((), dtype=logits.dtype, device=logits.device)).sum(dim=1)


def plm_loss(theta, msa, weights, lambda_h, lambda_j, l: int, q: int,
             mm_bf16: bool = False):
    """Regularized negative log-pseudolikelihood (symmetric-J variant).

    ``loss = sum_i sum_n -w_n log P(s_ni | s_n,-i) + lambda_h ||h||^2
    + lambda_J ||J_triu||^2``  (``plmdca_numerics.cpp:436-607``).
    ``mm_bf16``: the logits product takes bfloat16 operands (:func:`_mm`).
    """
    x, maskq = _prep_msa(msa, l, q, theta.dtype)
    h = theta[: l * q].reshape(l, q)
    logits = _logits_mm(x, _expand_w4(theta[l * q :], l, q), q, l, mm_bf16) + h.T[None]
    nll = (weights[:, None] * (_lse_q(logits) - _picked(logits, maskq))).sum()
    reg = lambda_h * (h * h).sum() + lambda_j * (theta[l * q :] ** 2).sum()
    return nll + reg


def plm_loss_and_grad(theta, msa, weights, lambda_h, lambda_j, l: int, q: int,
                      mm_bf16: bool = False):
    """``(loss, grad)`` of :func:`plm_loss` by torch autograd (the logits
    product's backward is :class:`_LogitsMM`'s)."""
    theta = theta.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = plm_loss(theta, msa, weights, lambda_h, lambda_j, l, q, mm_bf16)
        (grad,) = torch.autograd.grad(loss, theta)
    return loss.detach(), grad


def init_params(msa, weights, l: int, q: int, block: Optional[int] = None,
                mesh=None) -> torch.Tensor:
    """Reference initialization (``plmdca_numerics.cpp:207-249``): flat
    float32 ``theta`` with ``h_ia = log(weighted_count_ia + 1)`` centred per
    site and ``J = 0``.  ``block``: sum ``fi`` over blocks of this many
    sequences, so that no (N, L*q) one-hot is built.  ``mesh``: the counts
    and Meff are summed over the ranks before the log."""
    counts, meff = stats.weighted_counts(msa, weights, q, block, mesh)
    h = torch.log(counts / meff * meff + 1.0)  # fi * Meff, rounded as the reference does
    h = h - h.mean(dim=1, keepdim=True)
    theta = torch.zeros(l * q + l * (l - 1) // 2 * q * q, dtype=torch.float32,
                        device=msa.device)
    theta[: l * q] = h.reshape(-1)
    return theta


def _blocks(msa, weights, block: int, l: int, q: int, dtype):
    """``(x, maskq, weights)`` of each block of ``block`` sequences, built
    as it is reached; the last block may be short.  Each block is the span
    ``plm/block``, from its one-hot to the caller's request for the next."""
    for start in range(0, msa.shape[0], block):
        with span("plm/block"):
            x, maskq = _prep_msa(msa[start : start + block], l, q, dtype)
            yield x, maskq, weights[start : start + block]


def _data_term(h, w, batches, l: int, q: int, mm_bf16: bool = False):
    """The weighted negative log-pseudolikelihood over ``batches`` of
    ``(x, maskq, weights)`` at fields ``h`` ``(L, q)`` and logits operand
    ``w`` ``(L*q, q*L)``, its fields gradient ``(q, L)`` and its raw
    ``w`` gradient ``(L*q, q*L)``.  One batch's logits and cotangent are
    alive at a time, and each batch's ``x^T ct`` is added into the one
    ``w``-gradient buffer in place."""
    gw = torch.zeros((l * q, q * l), dtype=torch.float32, device=h.device)
    gh = torch.zeros((q, l), dtype=torch.float32, device=h.device)
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    if mm_bf16:
        w = w.to(torch.bfloat16)  # rounded once per evaluation, not per block
    for x, maskq, wb in batches:
        logits = _logits_mm(x, w, q, l, mm_bf16).add_(h.T[None])
        nll += _nll_at(logits, _picked(logits, maskq), wb)
        ct, gh_b = _ct_gh(logits, maskq, wb)
        del logits
        gh += gh_b
        _mm_b(x, ct, gw, mm_bf16)
        del x, maskq, ct
    return nll, gh, gw


def plm_loss_and_grad_chunked(theta, msa, weights, lambda_h, lambda_j,
                              l: int, q: int, block: int, mesh=None,
                              mm_bf16: bool = False):
    """Streamed ``(loss, grad)`` of :func:`plm_loss` over blocks of
    ``block`` sequences (``pydca_tpu/plm.py:487-539``).

    The pseudolikelihood is a plain sum over sequences, so the data term's
    value and gradient add up exactly across blocks, and only one block's
    one-hot, logits and cotangent are alive at a time: O(block * L * q)
    device memory instead of O(N * L * q).  Forward and backward are
    written by hand (:func:`_data_term`): the coupling operand ``W`` is
    expanded once per evaluation, and the ``(L*q, q*L)`` gradient buffer
    is pulled back to the pair layout once.  When ``block`` does not
    divide N, the last block holds the N mod block remaining rows (the JAX
    package pads it with zero-weight rows instead).  ``mesh``: ``msa`` and
    ``weights`` are this rank's stripe; the data term's value and gradient
    (after the pullback: D floats, half the ``(L*q, q*L)`` buffer) are
    summed over the ranks in one collective before the regulariser is
    added.  ``mm_bf16``: both products take bfloat16 operands; each
    block's one-hot is built in bfloat16.
    """
    lq = l * q
    h = theta[:lq].reshape(l, q)
    jflat = theta[lq:]
    w = _expand_w4(jflat, l, q)
    batches = _blocks(msa, weights, block, l, q, _x_dtype(mm_bf16))
    nll, gh, gw = _data_term(h, w, batches, l, q, mm_bf16)
    del w
    # the data term's gradient and value in one buffer, one collective
    buf = torch.empty(theta.shape[0] + 1, dtype=theta.dtype, device=theta.device)
    g = buf[:-1]
    g[:lq] = gh.T.reshape(-1)
    g[lq:] = _w4_cot_to_compact(gw, l, q)
    del gw
    buf[-1] = nll
    if mesh is not None:
        mesh.sum_(buf, "grad_allreduce")
    g[:lq] += (2.0 * lambda_h * h).reshape(-1)
    g[lq:].add_(jflat, alpha=2.0 * lambda_j)
    loss = buf[-1] + lambda_h * (h * h).sum() + lambda_j * torch.dot(jflat, jflat)
    return loss, g


def _nll_at(logits, picked, weights):
    """Weighted negative log-pseudolikelihood from carried logits/picked."""
    return (weights[:, None] * (_lse_q(logits) - picked)).sum()


def _ct_gh(logits, maskq, weights):
    """Logits cotangent w*(softmax - onehot) and its sequence-sum (the h
    gradient, ``(q, L)``).  Built in one (N, q, L) buffer, in place."""
    ct = (logits - logits.amax(dim=1, keepdim=True)).exp_()
    ct.div_(ct.sum(dim=1, keepdim=True)).sub_(maskq.to(ct.dtype))
    ct.mul_(weights[:, None, None])
    return ct, ct.sum(dim=0)


def _grad_at(logits, x1h, codes, weights, theta, lambda_h, lambda_j,
             l: int, q: int, mesh=None, mm_bf16: bool = False, picked=None, u=None,
             dh=None, alpha: float = 0.0) -> torch.Tensor:
    """Full flat gradient at the carried logits / parameters, the cotangent
    by :func:`~pydca_tpu_torch.ops.cuda_kernels.plm_update_grad` on the
    sequences' uint8 ``codes`` (:func:`_fused_inputs`).  With ``u``, the step's
    update comes first, in the same pass: ``logits`` and ``picked`` move
    by ``alpha`` along the direction's image ``u`` and fields ``dh``.
    ``mesh``: the data gradient (this rank's rows) is summed over the ranks
    in one flat buffer of D floats before ``2 lambda theta`` is added."""
    lq = l * q
    with span("plm/gradient"):
        ct, gh = plm_update_grad(logits, codes, weights, picked, u, dh, alpha)
        g = torch.empty_like(theta)
        g[:lq] = gh.T.reshape(-1)
        g[lq:] = _w4_cot_to_compact(_mm_b(x1h, ct, mm_bf16=mm_bf16), l, q)
        del ct
        if mesh is not None:
            mesh.sum_(g, "grad_allreduce")
        g[:lq] += (2.0 * lambda_h * theta[:lq]).reshape(-1)
        g[lq:] += 2.0 * lambda_j * theta[lq:]
    return g


def _data_sum(mesh, vals: torch.Tensor) -> torch.Tensor:
    """1-D data terms (sums over this rank's sequences) summed over the
    ranks in one collective, in place."""
    if mesh is not None:
        mesh.sum_(vals, "nll_allreduce")
    return vals


# ------------------------------------------------------ fused direction loop
@dataclass
class PlmFusedState:
    """State of the fused plm L-BFGS loop.

    Device tensors: ``x``, ``g`` (flat D), the ``(2m, D)`` history ``z``
    (float32; bfloat16 rows when resumed from a file that holds them,
    :func:`_load_state`) and the carried
    ``logits`` ``(N, q, L)`` / ``picked`` ``(N, L)``.
    Host float32: ``f`` and the scalar squares; ``zzt`` ``(2m, 2m)`` and
    ``zg`` ``(2m,)`` are CPU tensors.  ``host_syncs`` counts the
    device-to-host reads the loop has made.
    """

    x: torch.Tensor
    f: np.float32
    g: torch.Tensor
    z: torch.Tensor
    zzt: torch.Tensor
    zg: torch.Tensor
    gg: np.float32  # ||g||^2
    xx: np.float32  # ||x||^2 (scalar recurrence)
    rh: np.float32  # ||h||^2
    rj: np.float32  # ||theta_J||^2
    logits: torch.Tensor
    picked: torch.Tensor
    k: int
    done: bool
    converged: bool
    ls_failed: bool
    n_evals: int
    host_syncs: int = 0

    def theta(self) -> torch.Tensor:
        """Reference-layout flat parameter vector [h; J]."""
        return self.x

    def gnorm(self) -> float:
        return float(np.sqrt(self.gg))


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host -> device copy that does not wait for the device's queue."""
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _plm_fused_state0(
    msa, weights, lambda_h, lambda_j, l: int, q: int, m: int,
    epsilon: float = 1e-3, mesh=None, mm_bf16: bool = False,
) -> PlmFusedState:
    """Fresh state at the reference init (``plmdca_numerics.cpp:207-249``):
    ``h0 = log(fi * Meff + 1)`` centred per site, ``J = 0``, float32
    history rows.  ``mesh``: ``msa`` and ``weights`` are this rank's
    stripe; the carried logits are this rank's rows."""
    lh, lj = _F32(lambda_h), _F32(lambda_j)
    n = msa.shape[0]
    lq = l * q
    dim = lq + l * (l - 1) // 2 * q * q
    with span("plm/init"):
        x1h, codes = _fused_inputs(msa, l, q, _x_dtype(mm_bf16))
        theta = init_params(msa, weights, l, q, mesh=mesh)
        h0 = theta[:lq].reshape(l, q)
        # J0 = 0 exactly: the logits are the broadcast fields
        logits = h0.T[None].expand(n, q, l).contiguous()
        picked = _picked(logits, _pick_mask(codes, q))
        g = _grad_at(logits, x1h, codes, weights, theta, float(lh), float(lj), l, q, mesh,
                     mm_bf16)
        st = PlmFusedState(
            x=theta, f=_F32(0), g=g,
            z=torch.zeros((2 * m, dim), dtype=torch.float32, device=msa.device),
            zzt=torch.zeros((2 * m, 2 * m), dtype=torch.float32),
            zg=torch.zeros((2 * m,), dtype=torch.float32),
            gg=_F32(0), xx=_F32(0), rh=_F32(0), rj=_F32(0),
            logits=logits, picked=picked,
            k=0, done=False, converged=False, ls_failed=False, n_evals=1,
        )
        nll, rh, gg = fetch_f32(st, _data_sum(mesh, _nll_at(logits, picked, weights).reshape(1)),
                                torch.dot(theta[:lq], theta[:lq]), torch.dot(g, g))
    st.f = _F32(nll + lh * rh)
    st.rh, st.xx, st.gg = rh, rh, gg
    st.converged = st.done = gradient_converged(gg, rh, epsilon)
    return st


def _hist_combine(c: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``Z^T c`` in float32 for the host coefficients ``c``: one product
    over float32 rows; bfloat16 rows are upcast one at a time
    (``pydca_tpu/plm.py:1000-1007``), so no float32 copy of the history is
    made."""
    if z.dtype == torch.float32:
        return torch.matmul(_to_device(c, z.device), z)
    d = torch.zeros(z.shape[1], dtype=torch.float32, device=z.device)
    for r in range(z.shape[0]):
        d.add_(z[r], alpha=float(c[r]))
    return d


def _hist_dot(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``Z @ g`` in float32; bfloat16 rows are upcast one at a time
    (``pydca_tpu/plm.py:1102-1108``)."""
    if z.dtype == torch.float32:
        return torch.matmul(z, g)
    return torch.stack([torch.dot(row.float(), g) for row in z])


def _plm_fused_step(
    st: PlmFusedState, x1h, codes, weights, lh, lj, l: int, q: int,
    epsilon: float, ftol: float, wolfe: float, max_linesearch: int, mesh=None,
    mm_bf16: bool = False,
) -> None:
    """One fused L-BFGS iteration, updating ``st`` in place
    (``pydca_tpu/plm.py:996-1137``) on the sequences' uint8 ``codes``
    (:func:`_fused_inputs`); its parts are the spans ``plm/direction``,
    ``plm/linesearch`` (one ``plm/trial`` a trial), ``plm/update``,
    ``plm/gradient`` and ``plm/history``.  The passes over the ``(N, q,
    L)`` logits are two kernels: one a trial
    (:func:`~pydca_tpu_torch.ops.cuda_kernels.plm_trial`), and one that
    moves the logits to the accepted step and builds the gradient's
    cotangent (:func:`~pydca_tpu_torch.ops.cuda_kernels.plm_update_grad`)."""
    lq = l * q
    m = st.z.shape[0] // 2
    hist_bf16 = st.z.dtype == torch.bfloat16
    with span("plm/direction"):
        gamma, cfull, _, _ = direction_coeffs(
            st.zg, st.zzt, torch.tensor(st.gg), st.k, m
        )
        d = _hist_combine(cfull, st.z)  # Z^T c
        d.add_(st.g, alpha=float(gamma)).neg_()  # d = -(gamma*g + Z^T c)
        # exact dots over (d, g, x): the estimates from direction_coeffs can
        # lose low bits to cancellation
        dg0, dh2, dj2, hd, jd = fetch_f32(
            st, torch.dot(st.g, d), torch.dot(d[:lq], d[:lq]),
            torch.dot(d[lq:], d[lq:]), torch.dot(st.x[:lq], d[:lq]),
            torch.dot(st.x[lq:], d[lq:]),
        )
        # steepest-descent fallback on the EXACT dg0 (pydca_tpu/plm.py:1012-1026)
        bad_dir = dg0 >= 0
        if bad_dir:
            d = -st.g
            dg0 = -st.gg
            dh2, dj2, hd, jd = fetch_f32(
                st, torch.dot(d[:lq], d[:lq]), torch.dot(d[lq:], d[lq:]),
                torch.dot(st.x[:lq], d[:lq]), torch.dot(st.x[lq:], d[lq:]),
            )
    dnorm2 = max(_F32(dh2 + dj2), _F32(1e-30))
    c1 = _F32(2.0) * (lh * hd + lj * jd)
    c2 = lh * dh2 + lj * dj2
    reg0 = lh * st.rh + lj * st.rj

    # the direction's image in logits space: u' = u + dh, u = x1h @ E(d_J)
    # (its fields dh are added inside the passes)
    u = _logits_mm(x1h, _expand_w4(d[lq:], l, q), q, l, mm_bf16)
    dh = d[:lq].view(l, q)

    def phi(alpha):
        with span("plm/trial"):
            nll, dnll = fetch_f32(
                st, _data_sum(mesh, plm_trial(st.logits, codes, weights, st.picked, u, dh,
                                              float(alpha)))
            )
        return (
            nll + reg0 + c1 * alpha + c2 * alpha * alpha,
            dnll + c1 + _F32(2.0) * c2 * alpha,
        )

    step0 = _F32(1.0) / np.sqrt(dnorm2) if st.k == 0 else _F32(1.0)
    with span("plm/linesearch"):
        alpha, f_new, took, rounding, trials = wolfe_scalar(
            phi, st.f, dg0, step0, ftol, wolfe, max_linesearch
        )
    st.n_evals += trials
    if not took:
        # no step: the iterate, gradient and history stay as they are
        st.done = True
        st.converged = st.converged or rounding
        st.ls_failed = not rounding
        return

    a = float(alpha)
    with span("plm/update"):
        st.x.add_(d, alpha=a)
    # logits/picked move in place, in the gradient's pass: they are the
    # largest tensors of the fit (pydca_tpu/plm.py:1057)
    g_new = _grad_at(st.logits, x1h, codes, weights, st.x, float(lh), float(lj), l, q, mesh,
                     mm_bf16, st.picked, u, dh, a)
    del u
    with span("plm/history"):
        zg_old_rows = _hist_dot(st.z, g_new)  # Z @ g' with the rows before the write
        rows_dots = []
        if hist_bf16:
            # the new rows as they will be stored, and their dots with g'
            # (the JAX package reads Z @ g' from the rounded rows)
            s_row = (d * a).to(torch.bfloat16)
            y_row = (g_new - st.g).to(torch.bfloat16)
            rows_dots = [torch.dot(s_row.float(), g_new), torch.dot(y_row.float(), g_new)]
        vals = fetch_f32(st, zg_old_rows, torch.dot(g_new, g_new),
                         torch.dot(st.g, g_new), torch.dot(d, g_new), *rows_dots)
        zg_new = torch.tensor(vals[: 2 * m], dtype=torch.float32)
        gg_new, gog, dgn = vals[2 * m : 2 * m + 3]

        xd = hd + jd
        xx_new = max(st.xx + _F32(2.0) * alpha * xd + alpha * alpha * dnorm2, _F32(0.0))
        rh_new = st.rh + _F32(2.0) * alpha * hd + alpha * alpha * dh2
        rj_new = st.rj + _F32(2.0) * alpha * jd + alpha * alpha * dj2

        # history: one in-place row write per S and Y slot; the Gram is
        # bordered by scalar algebra on the host (pydca_tpu/plm.py:1110-1124)
        sy = alpha * (dgn - dg0)
        slot = st.k % m
        if sy > _F32(1e-10):
            if hist_bf16:
                st.z[slot].copy_(s_row)
                st.z[slot + m].copy_(y_row)
                zg_new[slot], zg_new[slot + m] = float(vals[-2]), float(vals[-1])
            else:
                torch.mul(d, a, out=st.z[slot])  # s = alpha * d
                torch.sub(g_new, st.g, out=st.z[slot + m])  # y = g' - g
                zg_new[slot] = float(alpha * dgn)  # s . g'
                zg_new[slot + m] = float(gg_new - gog)  # y . g'
            # Z@s = alpha * Z@d = -alpha*(gamma*Zg + ZZt@c);  Z@y = Z@g' - Z@g
            zd = -st.zg if bad_dir else -(gamma * st.zg + st.zzt @ cfull)
            zs_vec = zd * a
            zs_vec[slot] = float(alpha * alpha * dnorm2)
            zs_vec[slot + m] = float(sy)
            zy_vec = zg_new - st.zg
            zy_vec[slot] = float(sy)
            zy_vec[slot + m] = float(gg_new - _F32(2.0) * gog + st.gg)
            st.zzt[slot, :] = zs_vec
            st.zzt[:, slot] = zs_vec
            st.zzt[slot + m, :] = zy_vec
            st.zzt[:, slot + m] = zy_vec

    st.f = _F32(f_new)
    st.g = g_new
    st.zg = zg_new
    st.gg, st.xx, st.rh, st.rj = gg_new, xx_new, rh_new, rj_new
    st.k += 1
    st.converged = st.done = gradient_converged(gg_new, xx_new, epsilon)


def _plm_fused_steps(
    st: PlmFusedState, x1h, codes, weights, lambda_h, lambda_j,
    l: int, q: int, num_steps: int,
    epsilon: float = 1e-3, ftol: float = 1e-4, wolfe: float = 0.9,
    max_linesearch: int = 10, mesh=None, mm_bf16: bool = False,
) -> PlmFusedState:
    """Advance the fused optimizer by up to ``num_steps`` iterations (in
    place; returns ``st``), each the span ``plm/iteration``.  ``x1h``,
    ``codes``: :func:`_fused_inputs`."""
    lh, lj = _F32(lambda_h), _F32(lambda_j)
    k_end = st.k + num_steps
    while not st.done and st.k < k_end:
        with span("plm/iteration"):
            _plm_fused_step(st, x1h, codes, weights, lh, lj, l, q,
                            epsilon, ftol, wolfe, max_linesearch, mesh, mm_bf16)
    return st


def fused_state_from_numpy(leaves: dict, device) -> PlmFusedState:
    """A JAX ``pydca_tpu.plm.PlmFusedState`` (as a dict of numpy arrays,
    e.g. ``jax.device_get(state)._asdict()``) -> the port's state.

    Split ``(h, J)`` pairs become flat D vectors and the 2m history leaves
    are stacked into the ``(2m, D)`` history (bfloat16 when the leaves
    are); the caches carry over unchanged.
    """
    dev = torch.device(device)

    def flat(pair):
        return np.concatenate([np.asarray(pair[0]), np.asarray(pair[1])]).astype(np.float32)

    def dev_tensor(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    hist_bf16 = np.asarray(leaves["z"][0][0]).dtype.name == "bfloat16"
    return PlmFusedState(
        x=dev_tensor(flat(leaves["x"])),
        f=_F32(leaves["f"]),
        g=dev_tensor(flat(leaves["g"])),
        z=dev_tensor(np.stack([flat(r) for r in leaves["z"]])).to(
            torch.bfloat16 if hist_bf16 else torch.float32),
        zzt=torch.tensor(np.asarray(leaves["zzt"], np.float32)),
        zg=torch.tensor(np.asarray(leaves["zg"], np.float32)),
        gg=_F32(leaves["gg"]), xx=_F32(leaves["xx"]),
        rh=_F32(leaves["rh"]), rj=_F32(leaves["rj"]),
        logits=dev_tensor(leaves["logits"]),
        picked=dev_tensor(leaves["picked"]),
        k=int(leaves["k"]),
        done=bool(leaves["done"]),
        converged=bool(leaves["converged"]),
        ls_failed=bool(leaves["ls_failed"]),
        n_evals=int(leaves["n_evals"]),
    )


def lbfgs_state_from_numpy(leaves: dict, device) -> LBFGSState:
    """A JAX ``pydca_tpu.ops.lbfgs.LBFGSState`` (as a dict of numpy arrays,
    e.g. ``jax.device_get(state)._asdict()``) -> the port's generic state.

    ``s_hist`` and ``y_hist`` are stacked into the ``(2m, D)`` history;
    ``rho`` stays on the host.
    """
    dev = torch.device(device)

    def dev_tensor(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return LBFGSState(
        x=dev_tensor(leaves["x"]),
        f=_F32(leaves["f"]),
        g=dev_tensor(leaves["g"]),
        z=dev_tensor(np.concatenate([leaves["s_hist"], leaves["y_hist"]])),
        rho=torch.tensor(np.asarray(leaves["rho"], np.float32)),
        k=int(leaves["k"]),
        done=bool(leaves["done"]),
        converged=bool(leaves["converged"]),
        ls_failed=bool(leaves["ls_failed"]),
        n_evals=int(leaves["n_evals"]),
    )


# ------------------------------------------------ the generic loop
def _make_loss_fun(msa, weights, lambda_h, lambda_j, l: int, q: int, block: int,
                   mesh=None, mm_bf16: bool = False):
    """The generic loop's objective ``x -> (loss, grad)`` of one fit
    (``pydca_tpu/plm.py:591-616``): the streamed loss over blocks of
    ``block`` sequences."""
    return functools.partial(
        plm_loss_and_grad_chunked, msa=msa, weights=weights,
        lambda_h=lambda_h, lambda_j=lambda_j, l=l, q=q, block=block, mesh=mesh,
        mm_bf16=mm_bf16,
    )


def _plm_lbfgs_state0(msa, weights, lambda_h, lambda_j, l: int, q: int,
                      m: int, block: int, mesh=None, mm_bf16: bool = False) -> LBFGSState:
    """Fresh generic state at the reference init, ``fi`` summed over the
    sequence blocks (``pydca_tpu/plm.py:570-588``)."""
    x0 = init_params(msa, weights, l, q, block=block, mesh=mesh)
    fun = _make_loss_fun(msa, weights, lambda_h, lambda_j, l, q, block, mesh, mm_bf16)
    return lbfgs_init(fun, x0, m=m)


def _plm_lbfgs_steps(st: LBFGSState, msa, weights, lambda_h, lambda_j,
                     l: int, q: int, num_steps: int, block: int, mesh=None,
                     mm_bf16: bool = False) -> LBFGSState:
    """Advance the generic fit by up to ``num_steps`` iterations (in place;
    returns ``st``)."""
    fun = _make_loss_fun(msa, weights, lambda_h, lambda_j, l, q, block, mesh, mm_bf16)
    return lbfgs_steps(fun, st, num_steps)


# ------------------------------------------------------------ checkpoints
def _generic_from_fused(st: PlmFusedState) -> LBFGSState:
    """Fused -> generic state (``pydca_tpu/plm.py:1154-1170``): the same
    iterate and history, ``rho = 1 / (s . y)`` from the diagonal of the
    cached ``S Y^T`` block, 0 on an empty slot; bfloat16 rows become
    float32."""
    m = st.z.shape[0] // 2
    sy = torch.diagonal(st.zzt[:m, m:])
    rho = torch.where(sy != 0, 1.0 / torch.where(sy == 0, torch.ones_like(sy), sy),
                      torch.zeros_like(sy))
    return LBFGSState(
        x=st.x, f=st.f, g=st.g, z=st.z.to(torch.float32), rho=rho, k=st.k, done=st.done,
        converged=st.converged, ls_failed=st.ls_failed, n_evals=st.n_evals,
        host_syncs=st.host_syncs,
    )


def _fused_from_generic(gst: LBFGSState, x1h, codes, weights, lambda_h, lambda_j,
                        l: int, q: int, epsilon: float = 1e-3, mesh=None,
                        mm_bf16: bool = False) -> PlmFusedState:
    """Generic -> fused state at the checkpointed iterate
    (``pydca_tpu/plm.py:864-915, 1400-1416``): one forward for the carried
    logits, one gradient, and the history caches ``zzt = Z Z^T`` and
    ``zg = Z g`` rebuilt, so the resume is exact to float recompute, not
    bitwise.  ``mesh``: the logits are this rank's rows."""
    lq = l * q
    lh, lj = _F32(lambda_h), _F32(lambda_j)
    x = gst.x
    logits = _logits_mm(x1h, _expand_w4(x[lq:], l, q), q, l, mm_bf16).add_(
        x[:lq].reshape(l, q).T[None])
    picked = _picked(logits, _pick_mask(codes, q))
    g = _grad_at(logits, x1h, codes, weights, x, float(lh), float(lj), l, q, mesh, mm_bf16)
    m2 = gst.z.shape[0]
    st = PlmFusedState(
        x=x, f=_F32(0), g=g, z=gst.z,
        zzt=torch.zeros((m2, m2), dtype=torch.float32),
        zg=torch.zeros((m2,), dtype=torch.float32),
        gg=_F32(0), xx=_F32(0), rh=_F32(0), rj=_F32(0),
        logits=logits, picked=picked, k=gst.k, done=gst.done,
        converged=gst.converged, ls_failed=gst.ls_failed, n_evals=gst.n_evals,
        host_syncs=gst.host_syncs,
    )
    vals = fetch_f32(
        st, _data_sum(mesh, _nll_at(logits, picked, weights).reshape(1)),
        torch.dot(x[:lq], x[:lq]), torch.dot(x[lq:], x[lq:]), torch.dot(g, g),
        torch.matmul(gst.z, gst.z.T), torch.matmul(gst.z, g),
    )
    nll, st.rh, st.rj, st.gg = vals[:4]
    st.zzt = torch.tensor(vals[4 : 4 + m2 * m2], dtype=torch.float32).reshape(m2, m2)
    st.zg = torch.tensor(vals[4 + m2 * m2 :], dtype=torch.float32)
    st.f = _F32(nll + lh * st.rh + lj * st.rj)
    st.xx = _F32(st.rh + st.rj)
    st.converged = gst.converged or gradient_converged(st.gg, st.xx, epsilon)
    st.done = st.converged or gst.done
    return st


def _save_state(path: str, state) -> None:
    """Write ``state`` to the npz file ``path`` in the JAX package's format
    (``pydca_tpu/plm.py:1469-1495``): the same keys, shapes and dtypes
    (flat reference-layout D vectors, float32 arrays and 0-d scalars,
    int32 ``k`` and ``n_evals``, bool flags), so that either package
    resumes the other's file.  A fused state keeps its caches (resume is
    bitwise) and its ``(2m, D)`` history as ``z`` (bfloat16 rows as their
    exact float32 values, with ``z_bf16`` set); a generic state splits
    the history into ``s_hist`` and ``y_hist``.  The file is written next
    to ``path`` and renamed over it, so a process that dies while writing
    leaves the last checkpoint whole."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def host(t):
        return t.detach().to(torch.float32).cpu().numpy()

    def f32(v):
        return np.asarray(v, np.float32)

    if isinstance(state, PlmFusedState):
        arrays = dict(
            x=host(state.x), f=f32(state.f), g=host(state.g), z=host(state.z),
            zzt=host(state.zzt), zg=host(state.zg), gg=f32(state.gg), xx=f32(state.xx),
            rh=f32(state.rh), rj=f32(state.rj), logits=host(state.logits),
            picked=host(state.picked),
        )
    else:
        m = state.z.shape[0] // 2
        arrays = dict(
            x=host(state.x), f=f32(state.f), g=host(state.g), s_hist=host(state.z[:m]),
            y_hist=host(state.z[m:]), rho=host(state.rho),
        )
    arrays.update(
        k=np.asarray(state.k, np.int32), done=np.asarray(bool(state.done)),
        converged=np.asarray(bool(state.converged)),
        ls_failed=np.asarray(bool(state.ls_failed)),
        n_evals=np.asarray(state.n_evals, np.int32),
    )
    if isinstance(state, PlmFusedState):
        arrays["z_bf16"] = np.asarray(state.z.dtype == torch.bfloat16)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)


def _load_state(path: str, device):
    """Read a checkpoint of either package (``pydca_tpu/plm.py:1498-1524``):
    a :class:`PlmFusedState` when the file holds the fused caches, else an
    ``ops.lbfgs.LBFGSState``.  The D-vectors, the history and the carried
    logits go to ``device``; ``zzt``, ``zg`` and ``rho`` stay CPU tensors
    and the scalars host values.  A fused file written with bfloat16
    history rows (``z_bf16``; the JAX package's TPU default) loads them
    back as bfloat16, exactly (they are stored as their float32 values),
    and the fit goes on with bfloat16 rows, as the JAX package's does
    (``pydca_tpu/plm.py:1507-1509``)."""
    dev = torch.device(device)
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:

        def on_host(key):
            return torch.from_numpy(np.asarray(z[key], np.float32))

        def on_dev(key):
            return on_host(key).to(dev)

        flags = dict(k=int(z["k"]), done=bool(z["done"]), converged=bool(z["converged"]),
                     ls_failed=bool(z["ls_failed"]))
        if "zzt" in z.files:
            rows = on_dev("z")
            if "z_bf16" in z.files and bool(z["z_bf16"]):
                logger.info("checkpoint %s holds bfloat16 history rows; continuing with "
                            "bfloat16 rows", path)
                rows = rows.to(torch.bfloat16)
            return PlmFusedState(
                x=on_dev("x"), f=_F32(z["f"]), g=on_dev("g"), z=rows,
                zzt=on_host("zzt"), zg=on_host("zg"), gg=_F32(z["gg"]), xx=_F32(z["xx"]),
                rh=_F32(z["rh"]), rj=_F32(z["rj"]), logits=on_dev("logits"),
                picked=on_dev("picked"), n_evals=int(z["n_evals"]), **flags,
            )
        for key in ("x", "f", "g", "s_hist", "y_hist", "rho"):
            if key not in z.files:
                raise KeyError(f"checkpoint missing field {key}")
        hist = np.concatenate([np.asarray(z["s_hist"], np.float32),
                               np.asarray(z["y_hist"], np.float32)])
        return LBFGSState(
            x=on_dev("x"), f=_F32(z["f"]), g=on_dev("g"), z=torch.from_numpy(hist).to(dev),
            rho=on_host("rho"),
            # checkpoints from before the JAX package counted evaluations
            n_evals=int(z["n_evals"]) if "n_evals" in z.files else 0, **flags,
        )


def _check_space(state, path: str, l: int, q: int) -> None:
    """Raise ``ValueError`` unless a checkpoint holds this fit's compact
    parameter count.  A file of the JAX package's w2 space (``Lq +
    (Lq)^2`` entries, ``pydca_tpu/plm.py:1287``) is refused by name: its
    history vectors cannot be converted to the compact layout."""
    lq = l * q
    size = state.x.shape[0]
    if size == lq + lq * lq:
        raise ValueError(f"checkpoint {path} holds {size} parameters of the w2 parameter "
                         "space; this package fits the compact layout only")
    dim = lq + l * (l - 1) // 2 * q * q
    if size != dim:
        raise ValueError(f"checkpoint {path} holds {size} parameters; this fit has {dim}")


def _check_param_space(param_space: str) -> None:
    """Validate a ``param_space`` name, which the JAX package's signatures
    and CLI take: ``auto``, ``compact`` or ``w2``; any other name raises.
    The fit has one parameter space, the compact layout, so ``w2`` logs a
    warning and fits that layout."""
    if param_space not in ("auto", "compact", "w2"):
        raise PlmDCAException(
            f"invalid param_space {param_space!r}; choose auto, w2 or compact"
        )
    if param_space == "w2":
        logger.warning("param_space='w2' is accepted for the JAX package's interface; "
                       "the fit runs in the compact parameter layout")


def fit_plm(
    msa: torch.Tensor,
    weights: torch.Tensor,
    lambda_h: float,
    lambda_j: float,
    l: int,
    q: int,
    *,
    max_iterations: int = 100,
    m: int = 5,
    chunk_size: Optional[int] = 50,
    progress_fn=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 50,
    seq_block: Optional[int] = None,
    mm_bf16: Optional[bool] = None,
    mesh=None,
    param_space: str = "auto",
) -> LBFGSResult:
    """Run the plmDCA optimization on ``msa.device``.

    Without ``seq_block``, the fused full-batch loop; with it, the streamed
    objective over blocks of ``seq_block`` sequences under the generic loop
    (:func:`plm_loss_and_grad_chunked`), for deep alignments whose (N, q, L)
    tensors should not be whole on the device.  The fit runs in chunks of
    ``chunk_size`` iterations (``None``: one chunk); ``progress_fn(state)``
    is called after each chunk.  Reference budget: m=5, epsilon=1e-3,
    ftol=1e-4, <= ``max_iterations`` iterations (``plmdcaBackend.cpp:68-75``).

    ``mm_bf16``: both logits products take bfloat16 operands and
    accumulate in float32 (``None``: float32).  ``param_space``:
    :func:`_check_param_space`; every name fits the compact layout.

    ``checkpoint_path`` (``pydca_tpu/plm.py:1262-1385``; ``.npz`` is
    appended to a bare path): resume from the file when it exists, in
    whichever format it holds (the loop the arguments ask for continues);
    a file of the JAX package's w2 space raises (:func:`_check_space`).  Save the
    state after a chunk once ``checkpoint_every`` iterations have passed
    since the last save, and when the fit ends.  A chunk that raises
    ``RuntimeError`` (a device fault; never ``NotImplementedError``) is
    retried at most twice, each time from the file: a chunk updates the
    state in place, so the state in memory after an error is never
    continued.  Without a checkpoint the error propagates.

    ``mesh`` (:class:`~pydca_tpu_torch.parallel.mesh.DataMesh`): ``msa``
    and ``weights`` are this rank's stripe of the rows, and every sum over
    sequences (the counts of the init, the loss, its gradient, each
    line-search trial) is summed over the ranks; the iterate, the history
    and every host decision are replicated.  Under a mesh, rank 0 writes
    the checkpoint in the generic format after the ranks meet at a
    barrier, and every rank reads it: a resumed fused fit rebuilds its
    rows' logits (``_fused_from_generic``).
    """
    mm_bf16 = bool(mm_bf16)
    _check_param_space(param_space)
    weights = weights.to(torch.float32)
    step = max_iterations if chunk_size is None else int(chunk_size)
    use_fused = seq_block is None
    block = None if use_fused else int(seq_block)
    if checkpoint_path is not None and not checkpoint_path.endswith(".npz"):
        checkpoint_path = checkpoint_path + ".npz"
    prepped = []

    def fused_inputs():
        """The fused loop's one-hot and codes, built once per fit."""
        if not prepped:
            prepped.extend(_fused_inputs(msa, l, q, _x_dtype(mm_bf16)))
        return prepped

    def restore():
        """The checkpoint's state, in the form of this fit's loop."""
        state = _load_state(checkpoint_path, msa.device)
        _check_space(state, checkpoint_path, l, q)
        if isinstance(state, PlmFusedState) and (mesh is not None or not use_fused):
            # a fused file's logits cover every row: a rank rebuilds its own
            state = _generic_from_fused(state)
        if use_fused and not isinstance(state, PlmFusedState):
            return _fused_from_generic(state, *fused_inputs(), weights, lambda_h, lambda_j, l, q,
                                       mesh=mesh, mm_bf16=mm_bf16)
        return state

    def save(state):
        if mesh is None:
            _save_state(checkpoint_path, state)
            return
        mesh.barrier()  # every rank has finished the chunk
        if mesh.leader:  # the grid's first rank
            gen = _generic_from_fused(state) if isinstance(state, PlmFusedState) else state
            _save_state(checkpoint_path, gen)
        mesh.barrier()  # the file is whole before any rank reads it

    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        state = restore()
        logger.info("resumed plmDCA optimizer state at iteration %d", state.k)
    elif use_fused:
        state = _plm_fused_state0(msa, weights, lambda_h, lambda_j, l, q, m, mesh=mesh,
                                  mm_bf16=mm_bf16)
    else:
        state = _plm_lbfgs_state0(msa, weights, lambda_h, lambda_j, l, q, m, block, mesh,
                                  mm_bf16)
    logger.info("plmDCA fit on %d rows a card: %s", msa.shape[0],
                "fused loop" if use_fused else
                f"generic loop, streamed over blocks of {block}")
    opts = {}  # the options that are set, as keywords: the one-device f32 call is unchanged
    if mesh is not None:
        opts["mesh"] = mesh
    if mm_bf16:
        opts["mm_bf16"] = True
    last_saved = state.k
    retries = 2
    while state.k < max_iterations and not state.done:
        todo = min(step, max_iterations - state.k)
        try:
            if use_fused:
                _plm_fused_steps(state, *fused_inputs(), weights, lambda_h, lambda_j, l, q, todo,
                                 **opts)
            else:
                _plm_lbfgs_steps(state, msa, weights, lambda_h, lambda_j, l, q, todo, block,
                                 **opts)
        except NotImplementedError:
            raise
        except RuntimeError as exc:
            if retries <= 0 or checkpoint_path is None or not os.path.exists(checkpoint_path):
                raise
            retries -= 1
            logger.warning(
                "device error during L-BFGS chunk (%s); resuming from checkpoint %s "
                "(%d retries left)", exc, checkpoint_path, retries,
            )
            state = restore()
            continue
        if progress_fn is not None:
            progress_fn(state)
        ended = state.done or state.k >= max_iterations
        if checkpoint_path is not None and (state.k - last_saved >= checkpoint_every or ended):
            save(state)
            last_saved = state.k
    if not use_fused:
        return result_from_state(state)
    return LBFGSResult(
        x=state.theta(),
        fx=float(state.f),
        gnorm=state.gnorm(),
        num_iters=state.k,
        converged=state.converged,
        linesearch_failed=state.ls_failed,
        n_evals=state.n_evals,
        host_syncs=state.host_syncs,
    )


# ----------------------------------------------------------------- engine class
class PlmDCA:
    """Pseudolikelihood maximization DCA on one device or over a mesh.

    Mirrors the reference API (``pydca/plmdca/plmdca.py:47-104``): defaults
    ``seqid=0.8``, ``lambda_h = lambda_J = 0.2*(L-1)``, ``max_iterations=100``.
    ``num_threads`` is accepted for interface compatibility and ignored.
    ``device``: ``"cuda"`` or ``"cpu"`` (explicit; no fallback).
    ``seq_block``: fit with the loss streamed over blocks of this many
    sequences; ``None`` streams by itself past ``STREAMING_LOGITS_BYTES``
    of logits on the rows one card holds (:func:`fit_seq_block`: N on one
    device, as the JAX engine does; a rank's stripe under a mesh), while
    the whole-alignment statistics decide on N (:func:`streaming_block`).
    ``checkpoint_path``: save the optimizer state there and resume from it
    (:func:`fit_plm`), on either fit route.
    ``precision``: ``None``/``"auto"``/``"float32"`` or ``"bfloat16"``, the
    logits products' operands (:func:`resolve_precision`).
    ``param_space``: ``"auto"``/``"compact"`` or ``"w2"``, taken for the
    JAX engine's signature; every name fits the compact layout
    (:func:`_check_param_space`).
    ``mesh``: ``None``/``"single"`` (one device), ``"auto"`` (the default
    process group when its world size is above 1) or a
    :class:`~pydca_tpu_torch.parallel.mesh.DataMesh`: the weights' identity
    counts are split over the ranks by tiles and the fit by rows
    (:func:`~pydca_tpu_torch.parallel.fit.fit_plm_sharded`), on the
    mesh's device.  Every rank holds the whole alignment; the fitted
    parameters, and all scoring from them, are the same on every rank.
    """

    def __init__(
        self,
        msa_file,
        biomolecule: str,
        seqid: Optional[float] = None,
        lambda_h: Optional[float] = None,
        lambda_J: Optional[float] = None,
        max_iterations: Optional[int] = None,
        num_threads: Optional[int] = None,
        verbose: bool = False,
        *,
        device,
        seq_block: Optional[int] = None,
        checkpoint_path: Optional[str] = None,
        precision: Optional[str] = None,
        mesh=None,
        param_space: str = "auto",
    ):
        self.device = resolve_device(device)
        self.mesh = resolve_mesh(mesh, self.device)
        if self.mesh is not None:
            self.device = self.mesh.device
        set_precision()
        if isinstance(msa_file, MSA):
            self.msa = msa_file
        else:
            self.msa = read_msa(msa_file, biomolecule)
        self.__seqid = 0.8 if seqid is None else float(seqid)
        if not 0.0 < self.__seqid <= 1.0:
            raise PlmDCAException(f"invalid seqid {self.__seqid}")
        l = self.msa.seqs_len
        self.__lambda_h = 0.2 * (l - 1) if lambda_h is None else float(lambda_h)
        self.__lambda_j = 0.2 * (l - 1) if lambda_J is None else float(lambda_J)
        if self.__lambda_h < 0 or self.__lambda_j < 0:
            raise PlmDCAException("lambda_h and lambda_J must be non-negative")
        self.__max_iterations = 100 if max_iterations is None else int(max_iterations)
        if seq_block is None:
            # the whole-alignment statistics on this device stream on the
            # global N; the fit on the rows one card holds
            self.__seq_block = streaming_block(self.msa.num_seqs, l, self.msa.q)
            self.__fit_block = fit_seq_block(self.msa.num_seqs, l, self.msa.q, self.mesh)
        elif int(seq_block) < 1:
            raise PlmDCAException(f"invalid seq_block {seq_block}; must be >= 1")
        else:
            self.__seq_block = self.__fit_block = int(seq_block)
        self.__mm_bf16 = resolve_precision(precision)
        _check_param_space(param_space)
        self.__verbose = bool(verbose)
        self.__checkpoint_path = checkpoint_path
        self.__theta: Optional[torch.Tensor] = None
        self.__weights: Optional[torch.Tensor] = None
        self.__fit_result: Optional[LBFGSResult] = None
        # the last DI run's fixed-point statistics (score.TwoSiteStats)
        self.two_site_stats: Optional[score_mod.TwoSiteStats] = None
        # the last backmapped ranking's {MSA column -> refseq position}
        self.refseq_mapping: Optional[Dict[int, int]] = None
        self.timers = StageTimers()

    # ------------------------------------------------------------- properties
    @property
    def biomolecule(self):
        return self.msa.alphabet.name

    @property
    def sequence_identity(self):
        return self.__seqid

    @property
    def lambda_h(self):
        return self.__lambda_h

    @property
    def lambda_J(self):
        return self.__lambda_j

    @property
    def max_iterations(self):
        return self.__max_iterations

    @property
    def sequences_len(self):
        return self.msa.seqs_len

    @property
    def num_sequences(self):
        return self.msa.num_seqs

    @property
    def num_site_states(self):
        return self.msa.q

    @property
    def effective_num_sequences(self) -> float:
        """The sum of the sequence weights (Meff), float32 on the device."""
        return float(self.compute_seqs_weight().sum())

    @property
    def fit_result(self) -> Optional[LBFGSResult]:
        return self.__fit_result

    @property
    def mm_bf16(self) -> bool:
        """Whether the logits products run with bfloat16 operands."""
        return self.__mm_bf16

    @property
    def seq_block(self) -> Optional[int]:
        """Sequences per block of the whole-alignment statistics on this
        device (``fi``), decided on the global N; ``None``: in one pass.
        On one device the fit takes the same block (:attr:`fit_block`)."""
        return self.__seq_block

    @property
    def fit_block(self) -> Optional[int]:
        """Sequences per block of the fit's streamed loss on this card,
        decided on the rows the card holds (:func:`fit_seq_block`);
        ``None``: the card's rows whole, the fused loop."""
        return self.__fit_block

    # -------------------------------------------------------------- pipeline
    def _msa_tensor(self) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(self.msa.data)).to(self.device)

    def compute_seqs_weight(self) -> torch.Tensor:
        """(N,) float32 sequence weights on the engine's device."""
        if self.__weights is None:
            with self.timers.stage("weights"):
                if self.mesh is not None:
                    from .parallel.fit import sequence_weights_sharded

                    self.__weights = sequence_weights_sharded(
                        self.mesh, self.msa.data, self.__seqid, self.msa.q
                    )
                else:
                    self.__weights = stats.sequence_weights(
                        self._msa_tensor(), self.__seqid, self.msa.q,
                        dtype=torch.float32,
                    )
                sync(self.device)
            self.timers.add_rate("weights", self.msa.num_seqs, "seqs")
        return self.__weights

    def _theta(self) -> torch.Tensor:
        if self.__theta is None:
            l, q = self.msa.seqs_len, self.msa.q

            def _progress(state):
                logger.info(
                    "plmDCA iteration %d: fx=%.6f |g|=%.4e",
                    state.k, float(state.f), state.gnorm(),
                )

            weights = self.compute_seqs_weight()
            fit_kw = dict(
                max_iterations=self.__max_iterations,
                progress_fn=_progress if self.__verbose else None,
                checkpoint_path=self.__checkpoint_path,
                seq_block=self.__fit_block,
                mm_bf16=self.__mm_bf16,
            )
            with self.timers.stage("fit"):
                if self.mesh is not None:
                    from .parallel.fit import fit_plm_sharded

                    codes, w_s, _ = shard_msa(self.mesh, self.msa.data, weights)
                    res = fit_plm_sharded(
                        codes, biomolecule_q=q, lambda_h=self.__lambda_h,
                        lambda_j=self.__lambda_j, mesh=self.mesh, weights=w_s, **fit_kw,
                    )
                else:
                    res = fit_plm(
                        self._msa_tensor(), weights,
                        self.__lambda_h, self.__lambda_j, l, q, **fit_kw,
                    )
                sync(self.device)
            self.timers.add_rate("fit", res.num_iters, "iters")
            self.__fit_result = res
            if self.__verbose:
                logger.info(
                    "plmDCA L-BFGS: %d iterations, fx=%.6f, |g|=%.3e, "
                    "converged=%s, linesearch_failed=%s",
                    res.num_iters, res.fx, res.gnorm, res.converged,
                    res.linesearch_failed,
                )
                logger.info("plmDCA stage timings:\n%s", self.timers.summary())
            self.__theta = res.x
        return self.__theta

    def get_fields_and_couplings_from_backend(self) -> np.ndarray:
        """Optimize and return the flat float32 parameter vector in the
        reference layout (fields then couplings; ``plmdca.py:202-243``)."""
        return self._theta().cpu().numpy()

    def set_fields_and_couplings(self, params) -> None:
        """Score a given flat parameter vector instead of fitting one: the
        reference layout of :meth:`get_fields_and_couplings_from_backend`
        (length L*q + P*q*q), e.g. parameters fitted by the JAX package.
        It replaces any earlier fit (``fit_result`` becomes ``None``)."""
        l, q = self.msa.seqs_len, self.msa.q
        d = l * q + l * (l - 1) // 2 * q * q
        theta = torch.as_tensor(np.asarray(params, dtype=np.float32).reshape(-1))
        if theta.shape[0] != d:
            raise PlmDCAException(
                f"expected {d} parameters for L={l}, q={q}; got {theta.shape[0]}"
            )
        self.__theta = theta.to(self.device)
        self.__fit_result = None

    def coupling_blocks(self) -> torch.Tensor:
        """(P, q-1, q-1) gap-excluded coupling blocks in pair order."""
        l, q = self.msa.seqs_len, self.msa.q
        p = l * (l - 1) // 2
        return self._theta()[l * q :].reshape(p, q, q)[:, : q - 1, : q - 1]

    # ------------------------------------------------------- param extraction
    def get_fields_no_gap_state(self, params: Optional[np.ndarray] = None) -> np.ndarray:
        """Flat (L*(q-1),) fields with the gap state dropped."""
        if params is None:
            params = self.get_fields_and_couplings_from_backend()
        l, q = self.msa.seqs_len, self.msa.q
        return np.asarray(params)[: l * q].reshape(l, q)[:, : q - 1].reshape(-1)

    def get_couplings_no_gap_state(self, params: Optional[np.ndarray] = None) -> np.ndarray:
        """Flat (P*(q-1)^2,) couplings with gap states dropped
        (``plmdca.py:246-268``)."""
        if params is None:
            params = self.get_fields_and_couplings_from_backend()
        l, q = self.msa.seqs_len, self.msa.q
        p = l * (l - 1) // 2
        jt = np.asarray(params)[l * q :].reshape(p, q, q)
        return jt[:, : q - 1, : q - 1].reshape(-1)

    def get_fields_and_couplings_no_gap_state(self, params=None):
        if params is None:
            params = self.get_fields_and_couplings_from_backend()
        return (
            self.get_fields_no_gap_state(params),
            self.get_couplings_no_gap_state(params),
        )

    def shift_couplings(self, couplings_ij) -> np.ndarray:
        """Zero-sum-gauge shift of one (q-1)^2 coupling block."""
        qm1 = self.msa.q - 1
        block = torch.as_tensor(np.asarray(couplings_ij)).reshape(qm1, qm1)
        return score_mod.gauge_shift(block).numpy()

    def map_index_couplings(self, i, j, a, b) -> int:
        """Flat parameter-vector index of ``J_ij(a, b)`` for a pair ``i < j``
        (reference ``plmdca.py:183-199``; states here are 0-based)."""
        q, l = self.msa.q, self.msa.seqs_len
        return l * q + int(stats.pair_index(i, j, l)) * q * q + a * q + b

    def get_single_site_freqs(self) -> torch.Tensor:
        """Raw weighted ``fi`` of shape (L, q) (reference ``plmdca.py:613-633``),
        summed over the sequence blocks on the streaming route."""
        return stats.single_site_freqs(
            self._msa_tensor(), self.compute_seqs_weight(), self.msa.q,
            block=self.__seq_block,
        )

    def get_reg_single_site_freqs(self) -> torch.Tensor:
        """fi with the DI path's hard-coded pseudocount 0.5 (``plmdca.py:638-648``)."""
        return stats.regularize_fi(self.get_single_site_freqs(), self.msa.q, 0.5)

    def compute_two_site_model_fields(self, couplings=None) -> np.ndarray:
        """Two-site-model fields, shape ``(P, 2, q)``
        (reference ``plmdca.py:640-678``)."""
        l, q = self.msa.seqs_len, self.msa.q
        if couplings is None:
            blocks = self.coupling_blocks()
        else:
            qm1 = q - 1
            blocks = torch.tensor(np.asarray(couplings), device=self.device).reshape(-1, qm1, qm1)
        hi, hj = score_mod.two_site_model_fields(
            blocks, self.get_reg_single_site_freqs(), l, q
        )
        return torch.stack([hi, hj], dim=1).cpu().numpy()

    def compute_direct_info_unsorted_DI(self) -> np.ndarray:
        """Unsorted DI per pair, shape ``(P,)`` (reference ``plmdca.py:681-720``)."""
        return self._di_scores().cpu().numpy()

    # ----------------------------------------------------------------- scores
    def _fn_scores(self) -> torch.Tensor:
        return score_mod.frobenius_norms(self.coupling_blocks())

    def _di_scores(self) -> torch.Tensor:
        """DI (P,) on the device, each step a timed stage; the fixed point's
        statistics are kept in ``two_site_stats``."""
        self._theta()  # the fit is timed as its own stage
        di, self.two_site_stats = score_mod.engine_di(self)
        return di

    def _sorted(self, scores: torch.Tensor):
        res = score_mod.sorted_scores(scores, self.msa.seqs_len)
        sync(self.device)
        return res

    def compute_sorted_FN(self, seqbackmapper=None):
        self._theta()  # the fit is timed as its own stage, not as scoring
        with self.timers.stage("score"):
            res = self._sorted(self._fn_scores())
        return score_mod.backmapped(self, res, seqbackmapper)

    def compute_sorted_FN_APC(self, seqbackmapper=None):
        self._theta()
        with self.timers.stage("score"):
            res = self._sorted(score_mod.apc(self._fn_scores(), self.msa.seqs_len))
        return score_mod.backmapped(self, res, seqbackmapper)

    def compute_sorted_DI(self, seqbackmapper=None):
        di = self._di_scores()
        with self.timers.stage("sort"):
            res = self._sorted(di)
        return score_mod.backmapped(self, res, seqbackmapper)

    def compute_sorted_DI_APC(self, seqbackmapper=None):
        di = self._di_scores()
        with self.timers.stage("sort"):
            res = self._sorted(score_mod.apc(di, self.msa.seqs_len))
        return score_mod.backmapped(self, res, seqbackmapper)

    def get_mapped_site_pairs_dca_scores(self, sorted_dca_scores, seqbackmapper):
        """Sorted scores mapped onto the reference sequence
        (reference ``plmdca.py:527-560``)."""
        return score_mod.backmapped(self, sorted_dca_scores, seqbackmapper)

    # ------------------------------------------------------------ parameters
    def compute_params(
        self,
        seqbackmapper=None,
        ranked_by: Optional[str] = None,
        linear_dist: Optional[int] = None,
        num_site_pairs: Optional[int] = None,
    ):
        """Fields plus top-ranked gauge-shifted couplings
        (``pydca_tpu/plm.py:1877-1933``, reference ``plmdca.py:345-434``):
        the couplings of the top ``num_site_pairs`` pairs with
        ``|i - j| > linear_dist`` (default 4) ranked by ``ranked_by``
        (default FN_APC), each block gauge-shifted.  With a backmapper,
        sites are reference positions and ``num_site_pairs`` defaults to
        the reference's length; else to L."""
        rank = score_mod.ranking_method(self, ranked_by, PlmDCAException)
        dca_scores = rank(seqbackmapper=seqbackmapper)
        l, qm1 = self.msa.seqs_len, self.msa.q - 1
        fields, couplings = self.get_fields_and_couplings_no_gap_state()
        sites, n_pairs = score_mod.params_sites(self, seqbackmapper, num_site_pairs)
        pairs = score_mod.ranked_pairs(
            dca_scores, 4 if linear_dist is None else linear_dist, n_pairs
        )
        ks = [int(stats.pair_index(sites[i], sites[j], l)) for i, j in pairs]
        blocks = torch.from_numpy(couplings.reshape(-1, qm1, qm1)[ks])
        shifted = score_mod.gauge_shift(blocks).reshape(len(pairs), qm1 * qm1).numpy()
        fields_by_site = tuple((i, fields[qm1 * c : qm1 * (c + 1)]) for i, c in sites.items())
        return fields_by_site, tuple(zip(pairs, shifted))
