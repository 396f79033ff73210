"""The scalar machinery of the fused L-BFGS loop, on the host in float32.

Port of ``pydca_tpu/ops/lbfgs.py``'s ``direction_coeffs``,
``wolfe_scalar`` and ``_cubic_step`` (plus :class:`LBFGSResult`).  In the
fused plm loop (:mod:`pydca_tpu_torch.plm`) these decisions branch on
scalar values, so they run on the host: the history Gram is a (2m, 2m)
float32 tensor on the CPU, and each line-search trial costs one device
pass plus one device-to-host read of two scalars (``phi``).

Semantics mirrored from libLBFGS / the reference's plmdcaBackend, as in the JAX
package: strong-Wolfe bracket+zoom with ``ftol = 1e-4``, ``wolfe = 0.9``,
a cap of 10 trials (the reference's is 5; ``pydca_tpu/plm.py:986``), the
best-decrease fallback, and the float32 rounding exit treated as
completion (``plmdcaBackend.cpp:82-90``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["LBFGSResult", "direction_coeffs", "wolfe_scalar"]

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
    dtype and device as ``zg``); ``k`` is the host iteration counter.
    """
    dtype, dev = zg.dtype, zg.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    p = zg[:m]
    qv = zg[m:]
    sy_mat = zzt[:m, m:]
    yy_mat = zzt[m:, m:]
    slots = torch.arange(m, device=dev)
    d_diag = torch.diagonal(sy_mat)
    valid = d_diag != 0
    pos = torch.remainder(slots - k, m)  # ascending = oldest -> newest
    vv = valid[:, None] & valid[None, :]
    tri = (pos[:, None] <= pos[None, :]) & vv
    yy = torch.where(vv, yy_mat, zero)
    r_mat = torch.where(tri, sy_mat, zero) + torch.diag(torch.where(valid, zero, one))
    d_vec = torch.where(valid, d_diag, zero)

    newest = (k - 1) % m
    sy_n = sy_mat[newest, newest]
    yy_n = yy[newest, newest]
    if k > 0 and bool(yy_n > 0):
        gamma = sy_n / torch.clamp_min(yy_n, 1e-30)
    else:
        gamma = one

    rinv_p = torch.linalg.solve(r_mat, p)
    inner = d_vec * rinv_p + gamma * (yy @ rinv_p) - gamma * qv
    top = torch.linalg.solve(r_mat.T, inner)
    bot = -rinv_p
    cfull = torch.cat([top, gamma * bot])

    zg_c = torch.dot(zg, cfull)
    dg0 = -(gamma * gg + zg_c)
    dnorm2 = gamma * gamma * gg + 2.0 * gamma * zg_c + torch.dot(cfull, zzt @ cfull)
    if bool(dg0 >= 0):
        return one, torch.zeros_like(cfull), -gg, gg
    return gamma, cfull, dg0, torch.clamp_min(dnorm2, 1e-30)


def wolfe_scalar(
    phi: Callable[[np.float32], Tuple[np.float32, np.float32]],
    f0,
    dg0,
    step0,
    ftol: float,
    wolfe: float,
    max_linesearch: int,
):
    """Strong-Wolfe bracket+zoom line search over a SCALAR ``phi`` callback.

    ``phi(alpha) -> (value, derivative)``; every scalar here is float32
    (numpy), so the decisions match the JAX package's float32 carry.
    Returns ``(alpha, f_new, took_step, rounding, trials)``: ``alpha`` is
    the accepted (or best-decrease fallback) step, 0 when no step was
    resolvable; ``rounding`` mirrors libLBFGS's ROUNDING_ERROR-as-completed
    exit (plmdcaBackend.cpp:82-90).
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
    accepted = False
    trials = 0
    min_fgap = _F32(np.inf)

    with np.errstate(all="ignore"):
        while True:
            width_ok = (
                abs(hi - lo) > _F32(1e-10) * max(abs(hi), _F32(1.0))
                if stage == 1
                else True
            )
            if accepted or trials >= max_linesearch or not width_ok or not alpha > 0:
                break
            fnew, dgnew = phi(alpha)
            fnew, dgnew = _F32(fnew), _F32(dgnew)
            trials += 1
            min_fgap = min(min_fgap, _F32(fnew - f0))

            ok_suff = fnew <= f0 + ftol * alpha * dg0
            ok_curv = abs(dgnew) <= wolfe * abs(dg0)
            accept_now = ok_suff and ok_curv

            if fnew < best_f or accept_now:
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
    rounding = (not took_step) and min_fgap <= eps_f * abs(f0)
    if took_step:
        return best_a, best_f, True, False, trials
    return zero, f0, False, bool(rounding), trials


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
