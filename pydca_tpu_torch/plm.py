"""Pseudolikelihood-maximization DCA (plmDCA) in PyTorch.

Port of the full-batch main path of ``pydca_tpu/plm.py``: the objective,
the fused direction-space L-BFGS loop (``_plm_fused_state0`` /
``_plm_fused_steps`` / ``fit_plm``) and the :class:`PlmDCA` engine's FN
scoring.  The math is the JAX package's; its TPU compile workarounds are
not ported:

- the parameter vector is one flat float32 tensor of length
  ``D = L*q + P*q*q`` in the reference layout (fields site-major, then
  couplings pair-major; ``plmdca_numerics.cpp:319-365``), not a split
  (h, J) pair;
- the L-BFGS history is one ``(2m, D)`` tensor whose rows are written in
  place (rows 0..m-1 = S, m..2m-1 = Y), not 2m leaves behind a switch;
- the logits operand is the plain 2-D ``(L*q, q*L)`` coupling matrix and
  both logits products are ``torch.matmul``; logits keep the ``(N, q, L)``
  layout.

The loop structure is the JAX package's (see the note above
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
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import score as score_mod
from . import stats
from .device import resolve_device, set_precision, sync
from .io.fasta import MSA, read_msa
from .ops.lbfgs import LBFGSResult, direction_coeffs, wolfe_scalar
from .profiling import StageTimers

logger = logging.getLogger(__name__)

__all__ = [
    "PlmDCA",
    "PlmDCAException",
    "PlmFusedState",
    "fit_plm",
    "fused_state_from_numpy",
    "plm_loss",
    "plm_loss_and_grad",
]

_F32 = np.float32

# The JAX engine switches to its streaming loss when the per-evaluation
# logits tensor (N * L * q float32) would exceed 1 GiB
# (pydca_tpu/plm.py:1566-1573); the port keeps the test and raises.
STREAMING_LOGITS_BYTES = 1 << 30


class PlmDCAException(Exception):
    """Errors specific to the plmDCA engine."""


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


def _prep_msa(msa: torch.Tensor, l: int, q: int, dtype=torch.float32):
    """One-hot ``(N, L*q)`` (column ``j*q + b``) and per-state pick mask
    ``(N, q, L)`` for the loss; computed once per fit."""
    codes = msa.long()
    x = torch.nn.functional.one_hot(codes, q).to(dtype).reshape(msa.shape[0], l * q)
    states = torch.arange(q, device=msa.device)
    maskq = codes[:, None, :] == states[None, :, None]
    return x, maskq


def _expand_full(j_flat: torch.Tensor, l: int, q: int) -> torch.Tensor:
    """Flat (P*q*q,) couplings -> the full symmetric (L, L, q, q) tensor.

    ``J_full[i, j] = J_pair(i,j)`` for i < j, its transpose for i > j, zeros
    on the diagonal — the symmetric-variant storage the reference uses
    (``plmdca_numerics.cpp:501-517``).  Differentiable (autograd turns the
    gather into a scatter-add).
    """
    plan = _pair_plan(l, j_flat.device)
    jg = j_flat.reshape(-1, q * q)[plan.pidx].reshape(l, l, q, q)
    jfull = torch.where(plan.lower, jg.transpose(-1, -2), jg)
    return torch.where(plan.diag, torch.zeros((), dtype=jfull.dtype, device=jfull.device), jfull)


def _expand_w4(j_flat: torch.Tensor, l: int, q: int) -> torch.Tensor:
    """Flat pair couplings -> the 2-D ``(L*q, q*L)`` logits operand ``W``
    with ``W[j*q + b, a*L + i] = J_full[i, j, a, b]``, so that
    ``logits[n, a, i] = sum_{j,b} x[n, j*q+b] W[j*q+b, a*L+i] + h[i, a]``
    (``pydca_tpu/plm.py:283-286``)."""
    return _expand_full(j_flat, l, q).permute(1, 3, 2, 0).reshape(l * q, q * l)


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


def _logits_mm(x: torch.Tensor, w: torch.Tensor, q: int, l: int) -> torch.Tensor:
    """Forward logits product ``(N, Lq) @ (Lq, qL)`` -> ``(N, q, L)``."""
    return torch.matmul(x, w).reshape(-1, q, l)


def _mm_b(x: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """Backward logits product: ``x^T @ ct`` contracting N -> ``(Lq, qL)``."""
    return torch.matmul(x.T, ct.reshape(ct.shape[0], -1))


def _lse_q(logits: torch.Tensor) -> torch.Tensor:
    """Stable logsumexp over the middle (q) axis of ``(N, q, L)`` logits."""
    mx = logits.amax(dim=1).detach()
    return mx + torch.log(torch.exp(logits - mx[:, None, :]).sum(dim=1))


def _picked(logits: torch.Tensor, maskq: torch.Tensor) -> torch.Tensor:
    """Logit of each sequence's observed state, ``(N, L)``."""
    return torch.where(maskq, logits, torch.zeros((), dtype=logits.dtype, device=logits.device)).sum(dim=1)


def plm_loss(theta, msa, weights, lambda_h, lambda_j, l: int, q: int):
    """Regularized negative log-pseudolikelihood (symmetric-J variant).

    ``loss = sum_i sum_n -w_n log P(s_ni | s_n,-i) + lambda_h ||h||^2
    + lambda_J ||J_triu||^2``  (``plmdca_numerics.cpp:436-607``).
    """
    x, maskq = _prep_msa(msa, l, q, theta.dtype)
    h = theta[: l * q].reshape(l, q)
    logits = _logits_mm(x, _expand_w4(theta[l * q :], l, q), q, l) + h.T[None]
    nll = (weights[:, None] * (_lse_q(logits) - _picked(logits, maskq))).sum()
    reg = lambda_h * (h * h).sum() + lambda_j * (theta[l * q :] ** 2).sum()
    return nll + reg


def plm_loss_and_grad(theta, msa, weights, lambda_h, lambda_j, l: int, q: int):
    """``(loss, grad)`` of :func:`plm_loss` by torch autograd."""
    theta = theta.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = plm_loss(theta, msa, weights, lambda_h, lambda_j, l, q)
        (grad,) = torch.autograd.grad(loss, theta)
    return loss.detach(), grad


def _phi_dphi(logits, picked, u, upicked, weights, alpha: float):
    """phi(alpha) data term and its derivative: one elementwise pass.

    Exploits logits(alpha) = logits + alpha*u: no matmul, no expansion —
    softmax statistics and the ct.u contraction fall out of the same pass.
    Returns two 0-d device tensors.
    """
    t = logits + alpha * u
    mx = t.amax(dim=1)
    e = torch.exp(t - mx[:, None, :])
    se = e.sum(dim=1)  # (N, L)
    lse = mx + torch.log(se)
    pk = picked + alpha * upicked
    nll = (weights[:, None] * (lse - pk)).sum()
    su = (e * u).sum(dim=1) / se  # E_softmax[u]  (N, L)
    dnll = (weights[:, None] * (su - upicked)).sum()
    return nll, dnll


def _nll_at(logits, picked, weights):
    """Weighted negative log-pseudolikelihood from carried logits/picked."""
    return (weights[:, None] * (_lse_q(logits) - picked)).sum()


def _ct_gh(logits, maskq, weights):
    """Logits cotangent w*(softmax - onehot) and its sequence-sum (the h
    gradient, ``(q, L)``)."""
    mx = logits.amax(dim=1)
    e = torch.exp(logits - mx[:, None, :])
    sm = e / e.sum(dim=1)[:, None, :]
    ct = weights[:, None, None] * (sm - maskq.to(sm.dtype))
    return ct, ct.sum(dim=0)


def _grad_at(logits, x1h, maskq, weights, theta, lambda_h, lambda_j,
             l: int, q: int) -> torch.Tensor:
    """Full flat gradient at the carried logits / parameters."""
    lq = l * q
    ct, gh = _ct_gh(logits, maskq, weights)
    gj = _w4_cot_to_compact(_mm_b(x1h, ct), l, q)
    g = torch.empty_like(theta)
    g[:lq] = (gh.T + 2.0 * lambda_h * theta[:lq].reshape(l, q)).reshape(-1)
    g[lq:] = gj + 2.0 * lambda_j * theta[lq:]
    return g


def _prep_u(x1h, maskq, d, l: int, q: int):
    """Direction image in logits space: u = x1h @ E(d_J) + d_h (once per
    direction), plus its picked-state reduction."""
    u = _logits_mm(x1h, _expand_w4(d[l * q :], l, q), q, l)
    u += d[: l * q].reshape(l, q).T[None]
    return u, _picked(u, maskq)


# ------------------------------------------------------ fused direction loop
@dataclass
class PlmFusedState:
    """State of the fused plm L-BFGS loop.

    Device tensors: ``x``, ``g`` (flat D), the ``(2m, D)`` history ``z``
    and the carried ``logits`` ``(N, q, L)`` / ``picked`` ``(N, L)``.
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


def _fetch(st: PlmFusedState, *vals: torch.Tensor):
    """One device-to-host read of several tensors' values, as float32."""
    st.host_syncs += 1
    return [_F32(v) for v in torch.cat([v.reshape(-1) for v in vals]).tolist()]


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host -> device copy that does not wait for the device's queue."""
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _converged(gg, xx, epsilon) -> bool:
    return bool(np.sqrt(gg) / max(np.sqrt(xx), _F32(1.0)) <= _F32(epsilon))


def _plm_fused_state0(
    msa, weights, lambda_h, lambda_j, l: int, q: int, m: int,
    epsilon: float = 1e-3,
) -> PlmFusedState:
    """Fresh state at the reference init (``plmdca_numerics.cpp:207-249``):
    ``h0 = log(fi * Meff + 1)`` centred per site, ``J = 0``."""
    lh, lj = _F32(lambda_h), _F32(lambda_j)
    x1h, maskq = _prep_msa(msa, l, q)
    n = msa.shape[0]
    lq = l * q
    dim = lq + l * (l - 1) // 2 * q * q
    fi = stats.single_site_freqs(msa, weights, q)
    h0 = torch.log(fi * weights.sum() + 1.0)
    h0 = h0 - h0.mean(dim=1, keepdim=True)
    theta = torch.zeros(dim, dtype=torch.float32, device=msa.device)
    theta[:lq] = h0.reshape(-1)
    # J0 = 0 exactly: the logits are the broadcast fields
    logits = h0.T[None].expand(n, q, l).contiguous()
    picked = _picked(logits, maskq)
    g = _grad_at(logits, x1h, maskq, weights, theta, float(lh), float(lj), l, q)
    st = PlmFusedState(
        x=theta, f=_F32(0), g=g,
        z=torch.zeros((2 * m, dim), dtype=torch.float32, device=msa.device),
        zzt=torch.zeros((2 * m, 2 * m), dtype=torch.float32),
        zg=torch.zeros((2 * m,), dtype=torch.float32),
        gg=_F32(0), xx=_F32(0), rh=_F32(0), rj=_F32(0),
        logits=logits, picked=picked,
        k=0, done=False, converged=False, ls_failed=False, n_evals=1,
    )
    nll, rh, gg = _fetch(st, _nll_at(logits, picked, weights),
                         torch.dot(theta[:lq], theta[:lq]), torch.dot(g, g))
    st.f = _F32(nll + lh * rh)
    st.rh, st.xx, st.gg = rh, rh, gg
    st.converged = st.done = _converged(gg, rh, epsilon)
    return st


def _plm_fused_step(
    st: PlmFusedState, x1h, maskq, weights, lh, lj, l: int, q: int,
    epsilon: float, ftol: float, wolfe: float, max_linesearch: int,
) -> None:
    """One fused L-BFGS iteration, updating ``st`` in place
    (``pydca_tpu/plm.py:996-1137``)."""
    lq = l * q
    m = st.z.shape[0] // 2
    dev = st.x.device
    gamma, cfull, _, _ = direction_coeffs(
        st.zg, st.zzt, torch.tensor(st.gg), st.k, m
    )
    d = torch.matmul(_to_device(cfull, dev), st.z)  # Z^T c
    d.add_(st.g, alpha=float(gamma)).neg_()  # d = -(gamma*g + Z^T c)
    # exact dots over (d, g, x): the estimates from direction_coeffs can
    # lose low bits to cancellation
    dg0, dh2, dj2, hd, jd = _fetch(
        st, torch.dot(st.g, d), torch.dot(d[:lq], d[:lq]),
        torch.dot(d[lq:], d[lq:]), torch.dot(st.x[:lq], d[:lq]),
        torch.dot(st.x[lq:], d[lq:]),
    )
    # steepest-descent fallback on the EXACT dg0 (pydca_tpu/plm.py:1012-1026)
    bad_dir = dg0 >= 0
    if bad_dir:
        d = -st.g
        dg0 = -st.gg
        dh2, dj2, hd, jd = _fetch(
            st, torch.dot(d[:lq], d[:lq]), torch.dot(d[lq:], d[lq:]),
            torch.dot(st.x[:lq], d[:lq]), torch.dot(st.x[lq:], d[lq:]),
        )
    dnorm2 = max(_F32(dh2 + dj2), _F32(1e-30))
    c1 = _F32(2.0) * (lh * hd + lj * jd)
    c2 = lh * dh2 + lj * dj2
    reg0 = lh * st.rh + lj * st.rj

    u, upicked = _prep_u(x1h, maskq, d, l, q)

    def phi(alpha):
        nll, dnll = _fetch(
            st, *_phi_dphi(st.logits, st.picked, u, upicked, weights, float(alpha))
        )
        return (
            nll + reg0 + c1 * alpha + c2 * alpha * alpha,
            dnll + c1 + _F32(2.0) * c2 * alpha,
        )

    step0 = _F32(1.0) / np.sqrt(dnorm2) if st.k == 0 else _F32(1.0)
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
    st.x.add_(d, alpha=a)
    # in place: logits/picked are the largest tensors of the fit, and the
    # update saves a full (N, q, L) copy (pydca_tpu/plm.py:1057)
    st.logits.add_(u, alpha=a)
    st.picked.add_(upicked, alpha=a)
    del u, upicked
    g_new = _grad_at(st.logits, x1h, maskq, weights, st.x, float(lh), float(lj), l, q)
    zg_old_rows = torch.matmul(st.z, g_new)  # Z @ g' with the rows before the write
    vals = _fetch(st, zg_old_rows, torch.dot(g_new, g_new),
                  torch.dot(st.g, g_new), torch.dot(d, g_new))
    zg_new = torch.tensor(vals[: 2 * m], dtype=torch.float32)
    gg_new, gog, dgn = vals[2 * m :]

    xd = hd + jd
    xx_new = max(st.xx + _F32(2.0) * alpha * xd + alpha * alpha * dnorm2, _F32(0.0))
    rh_new = st.rh + _F32(2.0) * alpha * hd + alpha * alpha * dh2
    rj_new = st.rj + _F32(2.0) * alpha * jd + alpha * alpha * dj2

    # history: one in-place row write per S and Y slot; the Gram is
    # bordered by scalar algebra on the host (pydca_tpu/plm.py:1110-1124)
    sy = alpha * (dgn - dg0)
    slot = st.k % m
    if sy > _F32(1e-10):
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
    st.converged = st.done = _converged(gg_new, xx_new, epsilon)


def _plm_fused_steps(
    st: PlmFusedState, x1h, maskq, weights, lambda_h, lambda_j,
    l: int, q: int, num_steps: int,
    epsilon: float = 1e-3, ftol: float = 1e-4, wolfe: float = 0.9,
    max_linesearch: int = 10,
) -> PlmFusedState:
    """Advance the fused optimizer by up to ``num_steps`` iterations (in
    place; returns ``st``)."""
    lh, lj = _F32(lambda_h), _F32(lambda_j)
    k_end = st.k + num_steps
    while not st.done and st.k < k_end:
        _plm_fused_step(st, x1h, maskq, weights, lh, lj, l, q,
                        epsilon, ftol, wolfe, max_linesearch)
    return st


def fused_state_from_numpy(leaves: dict, device) -> PlmFusedState:
    """A JAX ``pydca_tpu.plm.PlmFusedState`` (as a dict of numpy arrays,
    e.g. ``jax.device_get(state)._asdict()``) -> the port's state.

    Split ``(h, J)`` pairs become flat D vectors and the 2m history leaves
    are stacked into the ``(2m, D)`` history; the caches carry over
    unchanged.
    """
    dev = torch.device(device)

    def flat(pair):
        return np.concatenate([np.asarray(pair[0]), np.asarray(pair[1])]).astype(np.float32)

    def dev_tensor(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return PlmFusedState(
        x=dev_tensor(flat(leaves["x"])),
        f=_F32(leaves["f"]),
        g=dev_tensor(flat(leaves["g"])),
        z=dev_tensor(np.stack([flat(r) for r in leaves["z"]])),
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
) -> LBFGSResult:
    """Run the fused full-batch plmDCA optimization on ``msa.device``.

    The fit runs in chunks of ``chunk_size`` iterations (``None``: one
    chunk); ``progress_fn(state)`` is called after each chunk.  Reference
    budget: m=5, epsilon=1e-3, ftol=1e-4, <= ``max_iterations`` iterations
    (``plmdcaBackend.cpp:68-75``).
    """
    weights = weights.to(torch.float32)
    x1h, maskq = _prep_msa(msa, l, q)
    state = _plm_fused_state0(msa, weights, lambda_h, lambda_j, l, q, m)
    step = max_iterations if chunk_size is None else int(chunk_size)
    while state.k < max_iterations and not state.done:
        todo = min(step, max_iterations - state.k)
        _plm_fused_steps(state, x1h, maskq, weights, lambda_h, lambda_j, l, q, todo)
        if progress_fn is not None:
            progress_fn(state)
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
    """Pseudolikelihood maximization DCA on one device.

    Mirrors the reference API (``pydca/plmdca/plmdca.py:47-104``): defaults
    ``seqid=0.8``, ``lambda_h = lambda_J = 0.2*(L-1)``, ``max_iterations=100``.
    ``num_threads`` is accepted for interface compatibility and ignored.
    ``device``: ``"cuda"`` or ``"cpu"`` (explicit; no fallback).
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
    ):
        self.device = resolve_device(device)
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
        logits_bytes = 4 * self.msa.num_seqs * l * self.msa.q
        if logits_bytes > STREAMING_LOGITS_BYTES:
            raise NotImplementedError(
                f"the (N, q, L) logits need {logits_bytes / 2**30:.1f} GiB > 1 GiB, "
                "where the JAX engine streams over sequence blocks; streaming "
                "is not ported yet (ROADMAP Queue 1 #10)"
            )
        self.__verbose = bool(verbose)
        self.__theta: Optional[torch.Tensor] = None
        self.__weights: Optional[torch.Tensor] = None
        self.__fit_result: Optional[LBFGSResult] = None
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
    def fit_result(self) -> Optional[LBFGSResult]:
        return self.__fit_result

    # -------------------------------------------------------------- pipeline
    def _msa_tensor(self) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(self.msa.data)).to(self.device)

    def compute_seqs_weight(self) -> torch.Tensor:
        """(N,) float32 sequence weights on the engine's device."""
        if self.__weights is None:
            with self.timers.stage("weights"):
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

            def _progress(state: PlmFusedState):
                logger.info(
                    "plmDCA iteration %d: fx=%.6f |g|=%.4e",
                    state.k, float(state.f), state.gnorm(),
                )

            weights = self.compute_seqs_weight()
            with self.timers.stage("fit"):
                res = fit_plm(
                    self._msa_tensor(), weights,
                    self.__lambda_h, self.__lambda_j, l, q,
                    max_iterations=self.__max_iterations,
                    progress_fn=_progress if self.__verbose else None,
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

    def coupling_blocks(self) -> torch.Tensor:
        """(P, q-1, q-1) gap-excluded coupling blocks in pair order."""
        l, q = self.msa.seqs_len, self.msa.q
        p = l * (l - 1) // 2
        return self._theta()[l * q :].reshape(p, q, q)[:, : q - 1, : q - 1]

    # ----------------------------------------------------------------- scores
    def _fn_scores(self) -> torch.Tensor:
        return score_mod.frobenius_norms(self.coupling_blocks())

    def _sorted(self, scores: torch.Tensor):
        res = score_mod.sorted_scores(scores, self.msa.seqs_len)
        sync(self.device)
        return res

    def compute_sorted_FN(self):
        self._theta()  # the fit is timed as its own stage, not as scoring
        with self.timers.stage("score"):
            return self._sorted(self._fn_scores())

    def compute_sorted_FN_APC(self):
        self._theta()
        with self.timers.stage("score"):
            return self._sorted(
                score_mod.apc(self._fn_scores(), self.msa.seqs_len)
            )
