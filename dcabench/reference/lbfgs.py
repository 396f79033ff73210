"""L-BFGS as pydca's plmDCA backend runs it (libLBFGS through
``plmdcaBackend.cpp:68-90``), in plain PyTorch and Python floats: m
history pairs and the two-loop direction with ``H0 = (s.y / y.y) I``, a
strong-Wolfe bracket-and-zoom line search with safeguarded cubic steps
(``ftol`` 1e-4, curvature 0.9, at most 10 trials, the first step
``1/||d||``), a pair kept when ``s.y > 1e-10``, the stop
``||g|| / max(1, ||x||) <= epsilon`` and at most ``max_iterations``
iterations.  The search's rules are a frozen copy of
``pydca_tpu_torch/ops/lbfgs.py:167-316`` (``wolfe_search``,
``_cubic_step``), here in double precision.

The plmDCA fit is judged by following this algorithm in float64 from the
same start: a fit that computes in a lower precision leaves the path by
more than a float32 fit does.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch

Fun = Callable[[torch.Tensor], Tuple[float, torch.Tensor]]


class Fit(NamedTuple):
    theta: torch.Tensor
    fx: float
    gnorm: float
    num_iters: int
    n_evals: int
    fx_path: Tuple[float, ...]  # the objective at the start and after each iteration


def _cubic_step(a, fa, da, b, fb, db, lo, hi):
    """Safeguarded cubic-Hermite minimiser of [lo, hi], clipped to its
    central 80%; the midpoint when degenerate."""
    d1 = da + db - 3.0 * (fa - fb) / (1.0 if a == b else a - b)
    disc = d1 * d1 - da * db
    sq = math.sqrt(max(disc, 0.0))
    sq = sq if b >= a else -sq
    denom = db - da + 2.0 * sq
    t = b - (b - a) * (db + sq - d1) / (1.0 if denom == 0 else denom)
    width = hi - lo
    ok = (math.isfinite(t) and disc >= 0 and denom != 0
          and lo + 0.1 * width < t < hi - 0.1 * width)
    return t if ok else 0.5 * (lo + hi)


def wolfe_search(phi: Callable[[float], Tuple[float, float]], f0: float, dg0: float,
                 step0: float, ftol: float = 1e-4, wolfe: float = 0.9,
                 max_linesearch: int = 10):
    """``(alpha, f, took_step, trials)``: the best trial, bracket then zoom."""
    stage, alpha = 0, step0
    lo, f_lo, dg_lo = 0.0, f0, dg0
    hi, f_hi, dg_hi = 0.0, f0, dg0
    best_a, best_f = 0.0, f0
    accepted, trials = False, 0
    while True:
        width_ok = abs(hi - lo) > 1e-10 * max(abs(hi), 1.0) if stage == 1 else True
        if accepted or trials >= max_linesearch or not width_ok or not alpha > 0:
            break
        fnew, dgnew = phi(alpha)
        trials += 1
        ok_suff = fnew <= f0 + ftol * alpha * dg0
        ok_curv = abs(dgnew) <= wolfe * abs(dg0)
        accept_now = ok_suff and ok_curv
        if fnew < best_f or accept_now:
            best_a, best_f = alpha, fnew
        old_lo, old_hi, trial = (lo, f_lo, dg_lo), (hi, f_hi, dg_hi), (alpha, fnew, dgnew)
        if stage == 0:
            to_zoom_hi = (not ok_suff) or (fnew >= f_lo and trials > 1)
            to_zoom_rev = ok_suff and not ok_curv and dgnew >= 0
            expand = ok_suff and not ok_curv and dgnew < 0
            if to_zoom_hi or to_zoom_rev:
                stage = 1
            new_lo = trial if (to_zoom_rev or expand) else old_lo
            new_hi = trial if to_zoom_hi else (old_lo if to_zoom_rev else old_hi)
        else:
            expand = False
            shrink_hi = (not ok_suff) or fnew >= f_lo
            flip = ok_suff and fnew < f_lo and dgnew * (hi - lo) >= 0
            new_lo = old_lo if shrink_hi else trial
            new_hi = trial if shrink_hi else (old_lo if flip else old_hi)
        (lo, f_lo, dg_lo), (hi, f_hi, dg_hi) = new_lo, new_hi
        if expand:
            alpha = min(alpha * 2.1, 1e20)
        else:
            alpha = _cubic_step(lo, f_lo, dg_lo, hi, f_hi, dg_hi, min(lo, hi), max(lo, hi))
        accepted = accepted or accept_now
    took = accepted or best_f < f0
    return (best_a, best_f, True, trials) if took else (0.0, f0, False, trials)


def minimize(fun: Fun, x0: torch.Tensor, *, m: int = 5, max_iterations: int = 100,
             epsilon: float = 1e-3) -> Fit:
    """Run the algorithm from ``x0`` (in ``x0``'s dtype)."""
    x = x0.clone()
    f, g = fun(x)
    n_evals, hist, path = 1, [], [f]
    k = 0
    while k < max_iterations:
        if float(g.norm()) / max(float(x.norm()), 1.0) <= epsilon:
            break
        qv = g.clone()
        alphas = []
        for s, y, rho in reversed(hist):  # newest -> oldest
            a = rho * float(s @ qv)
            qv -= a * y
            alphas.append(a)
        if hist:
            s, y, _ = hist[-1]
            qv *= float(s @ y) / float(y @ y)
        for (s, y, rho), a in zip(hist, reversed(alphas)):  # oldest -> newest
            qv += (a - rho * float(y @ qv)) * s
        d = -qv
        dg0 = float(g @ d)
        if dg0 >= 0:
            d, dg0 = -g, -float(g @ g)
        step0 = 1.0 / max(float(d.norm()), 1e-30) if k == 0 else 1.0
        trial = {}

        def phi(alpha):
            fa, ga = fun(x + alpha * d)
            trial[alpha] = (fa, ga)
            return fa, float(ga @ d)

        alpha, f_new, took, trials = wolfe_search(phi, f, dg0, step0)
        n_evals += trials
        if not took:
            break
        g_new = trial[alpha][1]
        s, y = alpha * d, g_new - g
        sy = float(s @ y)
        if sy > 1e-10:
            hist = (hist + [(s, y, 1.0 / sy)])[-m:]
        x, f, g = x + s, f_new, g_new
        path.append(f)
        k += 1
    return Fit(x, f, float(g.norm()), k, n_evals, tuple(path))
