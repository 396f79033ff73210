"""L-BFGS for the port: the scalar machinery of the fused plm loop and the
generic loop over a caller's objective.

Port of ``pydca_tpu/ops/lbfgs.py``:

- ``direction_coeffs``, ``wolfe_scalar`` and ``_cubic_step`` (plus
  :class:`LBFGSResult`), the scalar machinery of the fused plm loop
  (:mod:`pydca_tpu_torch.plm`).  ``direction_coeffs`` runs where the
  history Gram is: on a card one kernel launch that makes the host wait
  for nothing, on the CPU the m x m algebra in torch.  The strong-Wolfe
  search branches on scalar values, so it runs on the host: each
  line-search trial costs one device pass plus one device-to-host read of
  two scalars (``phi``).  The search itself is a resumable generator
  (``wolfe_search``), which ``wolfe_scalar`` drives one trial at a time.
- The generic loop over ``fun(x) -> (f, g)`` (:class:`LBFGSState`,
  ``_two_loop``, ``_wolfe_linesearch``, ``lbfgs_init``, ``lbfgs_steps``,
  ``result_from_state``, ``lbfgs_minimize``), which the streamed plm fit
  runs.  The state's D-vectors stay on the device; the history is one
  ``(2m, D)`` tensor whose rows are written in place (S rows 0..m-1, Y rows
  m..2m-1), and every scalar decision is taken on the host in float32 from
  one counted device-to-host read (``host_syncs``).  Its spans: a step's
  ``lbfgs/direction`` and ``lbfgs/linesearch``, and ``lbfgs/evaluation``
  around each call of ``fun`` (``n_evals`` of them a fit).
- The lock-step loop over F independent lanes (:class:`LBFGSBatch`,
  ``lbfgs_init_batch``, ``lbfgs_steps_batch``), the port of the JAX
  package's ``vmap`` of ``lbfgs_init`` / ``lbfgs_steps``, which the family
  fits run: one strong-Wolfe generator a lane, each round one evaluation
  of the lanes still searching and one read for all of them.

Semantics mirrored from libLBFGS / the reference's plmdcaBackend, as in the JAX
package: strong-Wolfe bracket+zoom with ``ftol = 1e-4``, ``wolfe = 0.9``,
a cap of 10 trials (the reference's is 5; ``pydca_tpu/plm.py:986``), the
best-decrease fallback, and the float32 rounding exit treated as
completion (``plmdcaBackend.cpp:82-90``).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..profiling import span
from .cuda_kernels import lbfgs_coeffs

__all__ = [
    "LBFGSBatch",
    "LBFGSResult",
    "LBFGSState",
    "direction_coeffs",
    "fetch_f32",
    "lbfgs_init",
    "lbfgs_init_batch",
    "lbfgs_minimize",
    "lbfgs_steps",
    "lbfgs_steps_batch",
    "result_from_state",
    "wolfe_scalar",
    "wolfe_search",
]

_F32 = np.float32


class LBFGSResult(NamedTuple):
    x: torch.Tensor
    fx: float
    gnorm: float
    num_iters: int
    converged: bool  # True when gradient criterion met OR rounding-limit exit
    linesearch_failed: bool
    n_evals: int  # total objective/gradient evaluations (incl. init)
    host_syncs: int = 0  # device-to-host scalar reads made by the loop
    discarded_trials: int = 0  # first trials queued ahead and thrown away (fused loop)


def _read_f32(*vals: torch.Tensor):
    """One device-to-host read of several tensors' values, as float32: the
    span ``lbfgs/read`` (the host's wait for the device and the copy)."""
    with span("lbfgs/read"):
        return [_F32(v) for v in torch.cat([v.reshape(-1) for v in vals]).tolist()]


def fetch_f32(st, *vals: torch.Tensor):
    """:func:`_read_f32`, counted in ``st.host_syncs``."""
    st.host_syncs += 1
    return _read_f32(*vals)


def gradient_converged(gg, xx, epsilon) -> bool:
    """libLBFGS's test ``||g|| / max(1, ||x||) <= epsilon`` from the float32
    squares ``gg = ||g||^2`` and ``xx = ||x||^2``."""
    return bool(np.sqrt(gg) / max(np.sqrt(xx), _F32(1.0)) <= _F32(epsilon))


def _host_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^-1 b`` for (..., m, m) and (..., m) host tensors, one LAPACK
    solve a matrix: torch's batched CPU solve runs MKL's thread pool, whose
    wake-ups can cost milliseconds a call inside a fit on a host that also
    drives the card (scripts/torch_lockstep_probe.py measures both), and a
    lane's solve stays the one its sequential run makes."""
    if a.dim() == 2:
        return torch.linalg.solve(a, b)
    m = a.shape[-1]
    rows = [torch.linalg.solve(ai, bi) for ai, bi in zip(a.reshape(-1, m, m), b.reshape(-1, m))]
    return torch.stack(rows).reshape(b.shape)


def _compact_coeffs(p, qv, sy_mat, yy_mat, valid, k, m: int):
    """``(gamma, cfull)`` of the Byrd-Nocedal-Schnabel direction
    ``d = -(gamma * g + Z.T @ cfull)`` from the m x m history algebra:
    ``p = S @ g``, ``qv = Y @ g``, ``sy_mat = S @ Y.T``, ``yy_mat = Y @ Y.T``
    and the (m,) bool mask of filled slots (H0 = gamma * I, R the
    chronologically upper-triangular part of S^T Y; an empty slot's R
    diagonal is padded to 1).  float32 host tensors; ``k`` is the host
    iteration counter.  Any leading axes are lanes, each its own history:
    ``k`` is then an int64 tensor of their shape, as is ``gamma``."""
    dtype, dev = p.dtype, p.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    k = torch.as_tensor(k, device=dev)
    slots = torch.arange(m, device=dev)
    d_diag = torch.diagonal(sy_mat, dim1=-2, dim2=-1)
    pos = torch.remainder(slots - k[..., None], m)  # ascending = oldest -> newest
    vv = valid[..., :, None] & valid[..., None, :]
    tri = (pos[..., :, None] <= pos[..., None, :]) & vv
    yy = torch.where(vv, yy_mat, zero)
    r_mat = torch.where(tri, sy_mat, zero) + torch.diag_embed(torch.where(valid, zero, one))
    d_vec = torch.where(valid, d_diag, zero)

    newest = torch.remainder(k - 1, m)[..., None]
    sy_n = torch.gather(d_diag, -1, newest)[..., 0]
    yy_n = torch.gather(torch.diagonal(yy, dim1=-2, dim2=-1), -1, newest)[..., 0]
    gamma = torch.where((k > 0) & (yy_n > 0), sy_n / torch.clamp_min(yy_n, 1e-30), one)

    rinv_p = _host_solve(r_mat, p)
    g_col = gamma[..., None]
    inner = d_vec * rinv_p + g_col * (yy * rinv_p[..., None, :]).sum(-1) - g_col * qv
    top = _host_solve(r_mat.transpose(-1, -2), inner)
    return gamma, torch.cat([top, g_col * -rinv_p], dim=-1)


def direction_coeffs(zg, zzt, gg, k: int, m: int):
    """Compact-representation direction as scalar coefficients (no D-vectors).

    For the stacked history ``Z = [S; Y]`` ((2m, D) rows, circular slots),
    given ``zg = Z @ g`` ((2m,)), the Gram ``zzt = Z @ Z.T`` ((2m, 2m)) and
    ``gg = ||g||^2``, returns ``(gamma_eff, cfull, dg0_est, dnorm2_est)``
    such that

        d = -(gamma_eff * g + Z.T @ cfull)

    is the Byrd-Nocedal-Schnabel direction (H0 = gamma * I, the
    chronologically upper-triangular R of S^T Y).  When the predicted
    directional derivative is non-negative the coefficients collapse to
    ``gamma_eff = 1, cfull = 0`` (d = -g).  Tensors in, tensors out (same
    dtype and device as ``zg``); ``k`` is the host iteration counter;
    ``gg`` a 0-d tensor or a host number.  This is
    :func:`~pydca_tpu_torch.ops.cuda_kernels.lbfgs_coeffs`: on a card one
    kernel launch, which makes the host wait for nothing; on the CPU the
    m x m algebra (:func:`_compact_coeffs`).
    """
    out = lbfgs_coeffs(zg, zzt, gg, k, m)
    return out[0], out[3:], out[1], out[2]


def wolfe_search(f0, dg0, step0, ftol: float, wolfe: float, max_linesearch: int):
    """Strong-Wolfe bracket+zoom line search as a resumable generator.

    Yields ``(alpha, kept)``: the next trial step, and whether the trial
    told last became the best one (the JAX rule ``fnew < best_f or
    accept_now``; False at the first yield), so that a caller can keep that
    trial's vectors.  Receives each trial's ``(value, derivative)`` through
    ``send``.  Returns (as ``StopIteration.value``) ``(alpha, f_new,
    took_step, rounding, trials, kept)`` with ``kept`` for the last trial
    told.  Every scalar is float32 (numpy), so the decisions match the JAX
    package's float32 carry.  A caller drives one search at a time
    (:func:`wolfe_scalar`) or many in lock-step (:func:`lbfgs_steps_batch`).
    """
    f0, dg0 = _F32(f0), _F32(dg0)
    ftol, wolfe = _F32(ftol), _F32(wolfe)
    eps_f = _F32(10.0) * np.finfo(np.float32).eps
    zero = _F32(0.0)

    stage = 0  # 0 = bracketing, 1 = zoom; (lo, hi) only meaningful in zoom
    alpha = _F32(step0)
    lo, f_lo, dg_lo = zero, f0, dg0
    hi, f_hi, dg_hi = zero, f0, dg0
    best_a, best_f = zero, f0
    accepted = kept = False
    trials = 0
    min_fgap = _F32(np.inf)

    while True:
        # errstate is process state: no yield inside a ``with`` block
        with np.errstate(all="ignore"):
            width_ok = (
                abs(hi - lo) > _F32(1e-10) * max(abs(hi), _F32(1.0))
                if stage == 1
                else True
            )
            if accepted or trials >= max_linesearch or not width_ok or not alpha > 0:
                break
        fnew, dgnew = yield alpha, kept
        with np.errstate(all="ignore"):
            fnew, dgnew = _F32(fnew), _F32(dgnew)
            trials += 1
            min_fgap = min(min_fgap, _F32(fnew - f0))

            ok_suff = fnew <= f0 + ftol * alpha * dg0
            ok_curv = abs(dgnew) <= wolfe * abs(dg0)
            accept_now = ok_suff and ok_curv

            kept = bool(fnew < best_f or accept_now)
            if kept:
                best_a, best_f = alpha, fnew

            # the same (possibly overlapping) transition flags as the JAX
            # carry; endpoints update from the OLD (lo, hi) values
            old_lo, old_hi = (lo, f_lo, dg_lo), (hi, f_hi, dg_hi)
            trial = (alpha, fnew, dgnew)
            if stage == 0:
                to_zoom_hi = (not ok_suff) or (fnew >= f_lo and trials > 1)
                to_zoom_rev = ok_suff and not ok_curv and dgnew >= 0
                expand = ok_suff and not ok_curv and dgnew < 0
                if to_zoom_hi or to_zoom_rev:
                    stage = 1
                new_lo = trial if (to_zoom_rev or expand) else old_lo
                new_hi = (
                    trial if to_zoom_hi else (old_lo if to_zoom_rev else old_hi)
                )
            else:
                expand = False
                shrink_hi = (not ok_suff) or fnew >= f_lo
                flip = ok_suff and fnew < f_lo and dgnew * (hi - lo) >= 0
                new_lo = old_lo if shrink_hi else trial
                new_hi = trial if shrink_hi else (old_lo if flip else old_hi)
            (lo, f_lo, dg_lo), (hi, f_hi, dg_hi) = new_lo, new_hi

            if expand:
                alpha = min(_F32(alpha * _F32(2.1)), _F32(1e20))
            else:
                alpha = _cubic_step(
                    lo, f_lo, dg_lo, hi, f_hi, dg_hi, min(lo, hi), max(lo, hi)
                )
            accepted = accepted or accept_now

    took_step = accepted or best_f < f0
    with np.errstate(all="ignore"):
        rounding = (not took_step) and min_fgap <= eps_f * abs(f0)
    if took_step:
        return best_a, best_f, True, False, trials, kept
    return zero, f0, False, bool(rounding), trials, kept


def wolfe_scalar(
    phi: Callable[[np.float32], Tuple[np.float32, np.float32]],
    f0,
    dg0,
    step0,
    ftol: float,
    wolfe: float,
    max_linesearch: int,
    on_best: Optional[Callable[[], None]] = None,
):
    """:func:`wolfe_search` over a SCALAR ``phi`` callback, one trial at a
    time.

    ``phi(alpha) -> (value, derivative)``.  Returns ``(alpha, f_new,
    took_step, rounding, trials)``: ``alpha`` is the accepted (or
    best-decrease fallback) step, 0 when no step was resolvable;
    ``rounding`` mirrors libLBFGS's ROUNDING_ERROR-as-completed exit
    (plmdcaBackend.cpp:82-90).  ``on_best()``, when given, is called right
    after each trial that becomes the best one, before the next ``phi``.
    """
    search = wolfe_search(f0, dg0, step0, ftol, wolfe, max_linesearch)
    reply = None
    while True:
        try:
            alpha, kept = search.send(reply)
        except StopIteration as stop:
            *result, kept = stop.value
            if kept and on_best is not None:
                on_best()
            return tuple(result)
        if kept and on_best is not None:
            on_best()
        reply = phi(alpha)


def _cubic_step(a, fa, da, b, fb, db, lo, hi):
    """Safeguarded cubic-Hermite minimizer of the interval, clipped to
    the central 80% of [lo, hi]; bisection fallback when degenerate.
    All arguments and the result are float32 scalars."""
    one = _F32(1.0)
    with np.errstate(all="ignore"):
        d1 = da + db - _F32(3.0) * (fa - fb) / (one if a == b else a - b)
        disc = d1 * d1 - da * db
        sq = np.sqrt(max(disc, _F32(0.0)))
        sq = sq if b >= a else -sq
        denom = db - da + _F32(2.0) * sq
        t = b - (b - a) * (db + sq - d1) / (one if denom == 0 else denom)
        width = hi - lo
        t_ok = (
            np.isfinite(t)
            and disc >= 0
            and denom != 0
            and t > lo + _F32(0.1) * width
            and t < hi - _F32(0.1) * width
        )
    return _F32(t) if t_ok else _F32(_F32(0.5) * (lo + hi))


# ------------------------------------------------------------- generic loop
@dataclass
class LBFGSState:
    """State of the generic L-BFGS loop (the JAX ``LBFGSState``'s fields).

    Device tensors: ``x``, ``g`` (D,) and the ``(2m, D)`` history ``z``,
    whose rows are the ``s_hist`` (0..m-1) and ``y_hist`` (m..2m-1) views.
    Host: ``f`` (float32), ``rho`` ((m,) float32 CPU tensor, ``1 / s.y`` of
    a filled slot, 0 for an empty one) and the counters and flags.
    ``host_syncs`` counts the device-to-host reads the loop has made.
    """

    x: torch.Tensor
    f: np.float32
    g: torch.Tensor
    z: torch.Tensor
    rho: torch.Tensor
    k: int
    done: bool
    converged: bool
    ls_failed: bool
    n_evals: int
    host_syncs: int = 0

    @property
    def s_hist(self) -> torch.Tensor:
        return self.z[: self.z.shape[0] // 2]

    @property
    def y_hist(self) -> torch.Tensor:
        return self.z[self.z.shape[0] // 2 :]

    def gnorm(self) -> float:
        """``||g||`` (one device read, not counted)."""
        return float(torch.linalg.norm(self.g))


def _two_loop_reference(g, s_hist, y_hist, rho, k: int) -> torch.Tensor:
    """Two-loop recursion over the circular history (reference form; empty
    slots carry rho == 0 and contribute nothing).  Kept for the tests:
    :func:`_two_loop` computes the same direction in the compact form."""
    m = s_hist.shape[0]
    rho = rho.to(g.device, g.dtype)
    qv = g.clone()
    alphas = torch.zeros(m, dtype=g.dtype, device=g.device)
    for idx in range(m):  # newest -> oldest
        slot = (k - 1 - idx) % m
        a = rho[slot] * torch.dot(s_hist[slot], qv)
        qv = qv - a * y_hist[slot]
        alphas[slot] = a
    newest = (k - 1) % m
    sy = torch.dot(s_hist[newest], y_hist[newest])
    yy = torch.dot(y_hist[newest], y_hist[newest])
    gamma = sy / torch.clamp_min(yy, 1e-30) if k > 0 and bool(yy > 0) else 1.0
    r = gamma * qv
    for idx in range(m):  # oldest -> newest
        slot = (k - m + idx) % m
        b = rho[slot] * torch.dot(y_hist[slot], r)
        r = r + s_hist[slot] * (alphas[slot] - b)
    return -r


def _two_loop(g, z, rho, k: int, fetch=_read_f32) -> torch.Tensor:
    """Compact-representation L-BFGS direction (Byrd-Nocedal-Schnabel 1994)
    over the ``(2m, D)`` history ``z = [S; Y]``, equal to the two-loop
    recursion with H0 = gamma * I (``pydca_tpu/ops/lbfgs.py::_two_loop``).

    Three products with the history, ``Z @ g``, ``Z @ Y.T`` and
    ``Z.T @ c``; the m x m algebra between them runs on the host in float32
    (:func:`_compact_coeffs`) from one device-to-host read (``fetch``).
    Filled slots are those with ``rho != 0``; an empty history gives
    ``-g`` exactly, with no read.
    """
    m = z.shape[0] // 2
    valid = rho != 0
    if not bool(valid.any()):
        return -g
    vals = fetch(torch.matmul(z, g), torch.matmul(z, z[m:].T))
    host = torch.tensor(vals, dtype=torch.float32)
    zg, zy = host[: 2 * m], host[2 * m :].reshape(2 * m, m)
    gamma, cfull = _compact_coeffs(zg[:m], zg[m:], zy[:m], zy[m:], valid, k, m)
    d = torch.matmul(cfull.to(z.device), z)
    return d.add_(g, alpha=float(gamma)).neg_()


def _wolfe_linesearch(fun, x, f0, g0, direction, dg0, step0, ftol, wolfe,
                      max_linesearch: int, fetch=_read_f32):
    """Strong-Wolfe search along ``direction`` over the vector objective
    ``fun(x) -> (f, g)`` (``pydca_tpu/ops/lbfgs.py::_wolfe_linesearch``).

    The bracket and zoom are :func:`wolfe_scalar`'s; ``phi(alpha)``
    evaluates ``fun(x + alpha * direction)`` and reads ``(f, g . d)`` in
    one ``fetch``.  The best trial's ``(x, f, g)`` stay on the device
    (at most one best and one current trial are alive).  Returns
    ``(x_out, f_out, g_out, took_step, rounding, trials)``, with
    ``(x, f0, g0)`` themselves when no step was taken.
    """
    out = [x, _F32(f0), g0]
    trial = [None, None, None]

    def phi(alpha):
        trial[:] = (None, None, None)  # free the last trial unless it is the best
        xnew = torch.add(x, direction, alpha=float(alpha))
        with span("lbfgs/evaluation"):
            fnew, gnew = fun(xnew)
        fv, dg = fetch(fnew, torch.dot(gnew, direction))
        trial[:] = (xnew, fv, gnew)
        return fv, dg

    def keep():
        out[:] = trial

    _, _, took, rounding, trials = wolfe_scalar(
        phi, f0, dg0, step0, ftol, wolfe, max_linesearch, on_best=keep
    )
    return out[0], out[1], out[2], took, rounding, trials


def lbfgs_init(
    fun: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    x0: torch.Tensor,
    *,
    m: int = 5,
    epsilon: float = 1e-3,
) -> LBFGSState:
    """Evaluate ``fun`` at ``x0`` and build the initial state (with the
    convergence check libLBFGS makes before iterating).  ``x0`` becomes the
    state's ``x``; :func:`lbfgs_steps` reuses its buffer."""
    with span("lbfgs/evaluation"):
        f0, g0 = fun(x0)
    st = LBFGSState(
        x=x0, f=_F32(0.0), g=g0,
        z=torch.zeros((2 * m, x0.shape[0]), dtype=x0.dtype, device=x0.device),
        rho=torch.zeros(m, dtype=torch.float32),
        k=0, done=False, converged=False, ls_failed=False, n_evals=1,
    )
    f, gg, xx = fetch_f32(st, f0, torch.dot(g0, g0), torch.dot(x0, x0))
    st.f = f
    st.converged = st.done = gradient_converged(gg, xx, epsilon)
    return st


def _lbfgs_step(fun, st: LBFGSState, epsilon, ftol, wolfe, max_linesearch) -> None:
    """One L-BFGS iteration, updating ``st`` in place
    (``pydca_tpu/ops/lbfgs.py:595-657``)."""
    m = st.z.shape[0] // 2
    fetch = functools.partial(fetch_f32, st)
    with span("lbfgs/direction"):
        d = _two_loop(st.g, st.z, st.rho, st.k, fetch)
        dg0, dd, gg = fetch(torch.dot(st.g, d), torch.dot(d, d), torch.dot(st.g, st.g))
        if dg0 >= 0:  # not a descent direction: steepest descent
            d = st.g.neg()
            dg0, dd = -gg, gg
    step0 = _F32(1.0) / max(np.sqrt(dd), _F32(1e-30)) if st.k == 0 else _F32(1.0)

    with span("lbfgs/linesearch"):
        x_new, f_new, g_new, took, rounding, trials = _wolfe_linesearch(
            fun, st.x, st.f, st.g, d, dg0, step0, ftol, wolfe, max_linesearch, fetch
        )
    st.n_evals += trials
    if not took:
        # no step: the iterate, gradient and history stay as they are
        st.done = True
        st.converged = st.converged or rounding
        st.ls_failed = not rounding
        return
    del d
    # s = x' - x and y = g' - g in the old x and g buffers, which the step
    # frees: no further D-sized temporaries
    s = st.x.neg_().add_(x_new)
    y = st.g.neg_().add_(g_new)
    sy, gg, xx = fetch(torch.dot(s, y), torch.dot(g_new, g_new), torch.dot(x_new, x_new))
    if sy > _F32(1e-10):
        slot = st.k % m
        st.z[slot].copy_(s)
        st.z[slot + m].copy_(y)
        st.rho[slot] = float(_F32(1.0) / sy)
    st.x, st.f, st.g = x_new, _F32(f_new), g_new
    st.k += 1
    st.converged = st.done = gradient_converged(gg, xx, epsilon)


def lbfgs_steps(
    fun: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    st: LBFGSState,
    num_steps: int,
    *,
    epsilon: float = 1e-3,
    ftol: float = 1e-4,
    wolfe: float = 0.9,
    max_linesearch: int = 10,
) -> LBFGSState:
    """Advance the optimizer by up to ``num_steps`` iterations (in place;
    returns ``st``).  ``k`` advances only on a step; a search that takes no
    step ends the run (``done``), as completion when float32 rounding hid
    every decrease (``converged``) and as ``ls_failed`` otherwise."""
    k_end = st.k + num_steps
    while not st.done and st.k < k_end:
        _lbfgs_step(fun, st, epsilon, ftol, wolfe, max_linesearch)
    return st


def result_from_state(st: LBFGSState) -> LBFGSResult:
    (gg,) = fetch_f32(st, torch.dot(st.g, st.g))
    return LBFGSResult(
        x=st.x,
        fx=float(st.f),
        gnorm=float(np.sqrt(gg)),
        num_iters=st.k,
        converged=st.converged,
        linesearch_failed=st.ls_failed,
        n_evals=st.n_evals,
        host_syncs=st.host_syncs,
    )


def lbfgs_minimize(
    fun: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    x0: torch.Tensor,
    *,
    m: int = 5,
    max_iterations: int = 100,
    epsilon: float = 1e-3,
    ftol: float = 1e-4,
    wolfe: float = 0.9,
    max_linesearch: int = 10,
) -> LBFGSResult:
    """Minimize ``fun`` (returning ``(value, grad)``) from ``x0`` (left
    unchanged); ``max_iterations`` counts outer iterations."""
    st = lbfgs_init(fun, x0.clone(), m=m, epsilon=epsilon)
    lbfgs_steps(fun, st, max_iterations, epsilon=epsilon, ftol=ftol,
                wolfe=wolfe, max_linesearch=max_linesearch)
    return result_from_state(st)


# ------------------------------------------------------- lock-step batch loop
# Lanes a flat GEMM of :func:`_lane_products` takes at once.  A batched
# GEMM whose contraction is the long D runs one thread block a lane (on an
# H100 80GB HBM3 at 700 W, 3 lanes at D = 1.4e7: ``Z @ Y.T`` 75.9 ms as
# ``bmm``, ``Z @ Z.T`` 1.7 ms as one flat GEMM; scripts/
# torch_lockstep_probe.py); the flat GEMM's multiply-adds grow with the
# group, its bytes do not, and up to 8 lanes it stays bound by the bytes.
_LANE_GROUP = 8


def _rowdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(F,) dots of the rows of two (F, D) tensors."""
    return torch.linalg.vecdot(a, b)


def _lane_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each lane's ``a[f] @ b[f].T`` for (F, p, D) and (F, r, D) tensors,
    (F, p, r): one flat GEMM a group of ``_LANE_GROUP`` lanes, whose
    diagonal blocks are the lanes' products."""
    nl, p, dim = a.shape
    r = b.shape[1]
    out = []
    for s in range(0, nl, _LANE_GROUP):
        ag, bg = a[s : s + _LANE_GROUP], b[s : s + _LANE_GROUP]
        g = ag.shape[0]
        full = torch.mm(ag.reshape(g * p, dim), bg.reshape(g * r, dim).T).view(g, p, g, r)
        out.append(torch.diagonal(full, dim1=0, dim2=2).permute(2, 0, 1))
    return torch.cat(out)


@dataclass
class LBFGSBatch:
    """F independent lanes of the generic loop in lock-step (the state of
    ``vmap(lbfgs_init)`` / ``vmap(lbfgs_steps)``,
    ``pydca_tpu/ops/lbfgs.py:540-659``).

    Device tensors hold the lanes that are not done: ``x``, ``g`` (A, D)
    and the ``(A, 2m, D)`` history ``z``, row ``r`` being lane
    ``rows[r]``.  A lane that is done leaves them for ``finished`` (its
    ``x``, ``g``, ``z`` bit for bit), so no later round touches it.  Host,
    one entry a lane: ``f`` (float32), ``rho`` ((F, m) float32 CPU tensor),
    ``k``, ``n_evals`` (int64), ``done``, ``converged``, ``ls_failed``
    (bool).  ``host_syncs`` counts the batch's device-to-host reads (one
    read serves every lane of a round); ``lane_iterations`` counts, over
    the loop's iterations, the lanes that ran each (a search that took no
    step included).
    """

    x: torch.Tensor
    g: torch.Tensor
    z: torch.Tensor
    rows: np.ndarray
    f: np.ndarray
    rho: torch.Tensor
    k: np.ndarray
    done: np.ndarray
    converged: np.ndarray
    ls_failed: np.ndarray
    n_evals: np.ndarray
    finished: dict = dataclasses.field(default_factory=dict)
    host_syncs: int = 0
    lane_iterations: int = 0

    def lane(self, i: int) -> LBFGSState:
        """Lane ``i`` as an :class:`LBFGSState` (views of the batch's
        tensors; ``host_syncs`` is the batch's)."""
        if i in self.finished:
            x, g, z = self.finished[i]
        else:
            r = int(np.flatnonzero(self.rows == i)[0])
            x, g, z = self.x[r], self.g[r], self.z[r]
        return LBFGSState(
            x=x, f=self.f[i], g=g, z=z, rho=self.rho[i], k=int(self.k[i]),
            done=bool(self.done[i]), converged=bool(self.converged[i]),
            ls_failed=bool(self.ls_failed[i]), n_evals=int(self.n_evals[i]),
            host_syncs=self.host_syncs,
        )


BatchFun = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def lbfgs_init_batch(fun: BatchFun, x0: torch.Tensor, *, m: int = 5,
                     epsilon: float = 1e-3) -> LBFGSBatch:
    """:func:`lbfgs_init` for F lanes at once.  ``fun(x, lanes)`` takes an
    (F', D) tensor whose row ``r`` is a point of lane ``lanes[r]`` (an int64
    tensor on ``x``'s device) and returns the (F',) values and (F', D)
    gradients; lanes are independent.  ``x0`` ((F, D)) becomes the state's
    ``x``.  One read for every lane's convergence check."""
    nl, dim = x0.shape
    f0, g0 = fun(x0, torch.arange(nl, device=x0.device))
    st = LBFGSBatch(
        x=x0, g=g0, z=torch.zeros((nl, 2 * m, dim), dtype=x0.dtype, device=x0.device),
        rows=np.arange(nl), f=np.zeros(nl, _F32), rho=torch.zeros((nl, m), dtype=torch.float32),
        k=np.zeros(nl, np.int64), done=np.zeros(nl, bool), converged=np.zeros(nl, bool),
        ls_failed=np.zeros(nl, bool), n_evals=np.ones(nl, np.int64),
    )
    f, gg, xx = np.asarray(fetch_f32(st, f0, _rowdot(g0, g0), _rowdot(x0, x0)),
                           _F32).reshape(3, nl)
    st.f = f
    st.done = np.array([gradient_converged(a, b, epsilon) for a, b in zip(gg, xx)], bool)
    st.converged = st.done.copy()
    return st


def _drop_done(st: LBFGSBatch) -> None:
    """Move the rows of lanes that are done to ``finished`` (cloned, so
    the live tensors shrink to the lanes still running)."""
    live = ~st.done[st.rows]
    if live.all() or not live.any():
        return
    for r in np.flatnonzero(~live):
        st.finished[int(st.rows[r])] = (st.x[r].clone(), st.g[r].clone(), st.z[r].clone())
    keep = torch.from_numpy(np.flatnonzero(live)).to(st.x.device)
    st.x, st.g, st.z = st.x[keep], st.g[keep], st.z[keep]
    st.rows = st.rows[live]


def _batch_directions(st: LBFGSBatch, m: int, fetch) -> torch.Tensor:
    """Every live lane's :func:`_two_loop` direction, (A, D): one read of
    ``Z @ g`` and ``Z @ Y.T`` for the lanes with a filled slot, the m x m
    algebra of those lanes in one host call, then one batched combine."""
    nr = len(st.rows)
    rho = st.rho[torch.from_numpy(st.rows)]
    valid = rho != 0
    coef = torch.zeros((nr, 2 * m + 1), dtype=torch.float32)  # [cfull, gamma]
    coef[:, -1] = 1.0
    hist = np.flatnonzero(valid.any(dim=1).numpy())
    if hist.size:
        sel = torch.from_numpy(hist).to(st.x.device)
        zg = _lane_products(st.z, st.g.unsqueeze(1)).squeeze(2)
        zy = _lane_products(st.z, st.z)[:, :, m:]
        host = torch.tensor(fetch(zg[sel], zy[sel]), dtype=torch.float32)
        zg_h = host[: hist.size * 2 * m].reshape(-1, 2 * m)
        zy_h = host[hist.size * 2 * m :].reshape(-1, 2 * m, m)
        h = torch.from_numpy(hist)
        gamma, cfull = _compact_coeffs(zg_h[:, :m], zg_h[:, m:], zy_h[:, :m], zy_h[:, m:],
                                       valid[h], torch.from_numpy(st.k[st.rows[hist]]), m)
        coef[h, :-1] = cfull
        coef[h, -1] = gamma
    coef = coef.to(st.x.device, st.x.dtype)
    d = torch.bmm(coef[:, None, :-1], st.z).squeeze(1)
    return d.addcmul_(coef[:, -1:], st.g).neg_()


def _lbfgs_step_batch(fun: BatchFun, st: LBFGSBatch, epsilon, ftol, wolfe,
                      max_linesearch) -> None:
    """One lock-step iteration of every live lane: :func:`_lbfgs_step` per
    lane, with each read shared by the lanes of the round."""
    m = st.z.shape[1] // 2
    dev = st.x.device
    fetch = functools.partial(fetch_f32, st)
    rows = st.rows
    nr = len(rows)
    st.lane_iterations += nr
    d = _batch_directions(st, m, fetch)
    dg0, dd, gg = np.asarray(
        fetch(_rowdot(st.g, d), _rowdot(d, d), _rowdot(st.g, st.g)), _F32).reshape(3, nr)
    bad = np.flatnonzero(dg0 >= 0)  # not a descent direction: steepest descent
    if bad.size:
        bad_t = torch.from_numpy(bad).to(dev)
        d[bad_t] = st.g[bad_t].neg()
        dg0[bad], dd[bad] = -gg[bad], gg[bad]

    # one strong-Wolfe search a lane, all advanced together: each round is
    # one evaluation of the lanes still searching and one read
    searches, step, kept, result = [], np.zeros(nr, _F32), np.zeros(nr, bool), [None] * nr
    for r, lane in enumerate(rows):
        step0 = _F32(1.0) / max(np.sqrt(dd[r]), _F32(1e-30)) if st.k[lane] == 0 else _F32(1.0)
        searches.append(wolfe_search(st.f[lane], dg0[r], step0, ftol, wolfe, max_linesearch))
    replies = [None] * nr
    xb, gb = st.x.clone(), st.g.clone()  # each lane's best trial (its x, g if none)
    lanes_dev = torch.from_numpy(rows).to(dev)
    trial = None
    while True:
        for r in range(nr):
            if result[r] is not None:
                continue
            try:
                step[r], kept[r] = searches[r].send(replies[r])
            except StopIteration as stop:
                *result[r], kept[r] = stop.value
        told = np.flatnonzero(kept & (trial is not None))
        if told.size:
            pos = np.searchsorted(trial[0], told)
            dst, src = (torch.from_numpy(v).to(dev) for v in (told, pos))
            xb.index_copy_(0, dst, trial[1].index_select(0, src))
            gb.index_copy_(0, dst, trial[2].index_select(0, src))
        kept[:] = False
        live = np.flatnonzero([res is None for res in result])
        if not live.size:
            break
        trial = None  # free the last trial before the next
        if live.size == nr:
            xt = torch.addcmul(st.x, torch.from_numpy(step).to(dev)[:, None], d)
            dt, lt = d, lanes_dev
        else:
            sel = torch.from_numpy(live).to(dev)
            dt = d.index_select(0, sel)
            xt = st.x.index_select(0, sel).addcmul_(
                torch.from_numpy(step[live]).to(dev)[:, None], dt)
            lt = lanes_dev.index_select(0, sel)
        ft, gt = fun(xt, lt)
        vals = np.asarray(fetch(ft, _rowdot(gt, dt)), _F32).reshape(2, live.size)
        for j, r in enumerate(live):
            replies[r] = (vals[0, j], vals[1, j])
        trial = (live, xt, gt)
        del dt, xt, gt, ft
    del trial, d

    f_new = np.array([res[1] for res in result], _F32)
    took = np.array([res[2] for res in result], bool)
    for r, lane in enumerate(rows):
        st.n_evals[lane] += result[r][4]
        if not took[r]:
            # no step: the lane's iterate, gradient and history stay as they are
            st.done[lane] = True
            st.converged[lane] = st.converged[lane] or result[r][3]
            st.ls_failed[lane] = not result[r][3]
    if not took.any():
        return
    # s = x' - x and y = g' - g in the old buffers (zero on lanes without a
    # step, whose x' and g' are copies of x and g)
    s = st.x.neg_().add_(xb)
    y = st.g.neg_().add_(gb)
    stepped = np.flatnonzero(took)
    sel = torch.from_numpy(stepped).to(dev)
    sy, gg, xx = np.asarray(
        fetch(_rowdot(s, y)[sel], _rowdot(gb, gb)[sel], _rowdot(xb, xb)[sel]), _F32
    ).reshape(3, stepped.size)
    upd = sy > _F32(1e-10)
    if upd.any():
        r_upd = stepped[upd]
        slots = st.k[rows[r_upd]] % m
        r_t, s_t = torch.from_numpy(r_upd).to(dev), torch.from_numpy(slots).to(dev)
        st.z[r_t, s_t] = s[r_t]
        st.z[r_t, s_t + m] = y[r_t]
        st.rho[torch.from_numpy(rows[r_upd]), torch.from_numpy(slots)] = torch.from_numpy(
            _F32(1.0) / sy[upd])
    del s, y
    st.x, st.g = xb, gb
    for j, r in enumerate(stepped):
        lane = rows[r]
        st.f[lane] = f_new[r]
        st.k[lane] += 1
        st.converged[lane] = st.done[lane] = gradient_converged(gg[j], xx[j], epsilon)


def lbfgs_steps_batch(
    fun: BatchFun,
    st: LBFGSBatch,
    num_steps: int,
    *,
    epsilon: float = 1e-3,
    ftol: float = 1e-4,
    wolfe: float = 0.9,
    max_linesearch: int = 10,
) -> LBFGSBatch:
    """:func:`lbfgs_steps` for every lane of ``st`` in lock-step (in
    place; returns ``st``): up to ``num_steps`` iterations a lane, the loop
    running until the slowest lane is done or has taken them.  A lane's
    ``k``, ``n_evals`` and flags are those of its own sequential run; a
    lane that is done is left as it is."""
    k_end = st.k + num_steps
    while True:
        _drop_done(st)
        if not (~st.done[st.rows] & (st.k[st.rows] < k_end[st.rows])).any():
            return st
        _lbfgs_step_batch(fun, st, epsilon, ftol, wolfe, max_linesearch)
