"""plmDCA in plain PyTorch: the regularised negative log-pseudolikelihood,
its gradient, pydca's start, FN-APC, and the fit (:mod:`.lbfgs`).

Parameters are pydca's flat layout: the fields ``h[i, a]`` at ``i*q + a``,
then for each pair ``i < j`` in row-major pair order a ``q x q`` block
``J_ij[a, b]`` (``a`` the state at ``i``, ``b`` at ``j``).  The objective
(pydca's ``plmdca_numerics.cpp:436-607``, symmetric couplings):

    sum_n w_n sum_i [log sum_a exp(l_nia) - l_ni(s_ni)]
        + lambda_h ||h||^2 + lambda_J ||J||^2,
    l_nia = h[i, a] + sum_{j != i} J_ij[a, s_nj]

Here the couplings are held as the symmetric (Lq, Lq) matrix
``M[(i,a), (j,b)] = J_ij[a, b]`` (zero diagonal blocks), so the logits are
``X @ M`` for the (N, Lq) one-hot ``X``, and the couplings' gradient is
``G^T X`` read at both of each pair's positions.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import one_hot, tf32
from .lbfgs import Fit, minimize


def n_params(l: int, q: int) -> int:
    return l * q + l * (l - 1) // 2 * q * q


def _pairs(l: int, device):
    iu, ju = np.triu_indices(l, k=1)
    return torch.from_numpy(iu).to(device), torch.from_numpy(ju).to(device)


def coupling_matrix(theta: torch.Tensor, l: int, q: int) -> torch.Tensor:
    """The symmetric (Lq, Lq) coupling matrix of a flat parameter vector."""
    iu, ju = _pairs(l, theta.device)
    jp = theta[l * q:].reshape(-1, q, q)
    m = torch.zeros((l, q, l, q), dtype=theta.dtype, device=theta.device)
    m[iu, :, ju, :] = jp
    m[ju, :, iu, :] = jp.transpose(1, 2)
    return m.reshape(l * q, l * q)


def _pair_grad(dm: torch.Tensor, l: int, q: int) -> torch.Tensor:
    iu, ju = _pairs(l, dm.device)
    d4 = dm.reshape(l, q, l, q)
    return (d4[iu, :, ju, :] + d4[ju, :, iu, :].transpose(1, 2)).reshape(-1)


def objective(theta: torch.Tensor, codes: torch.Tensor, weights: torch.Tensor,
              lambda_h: float, lambda_j: float, l: int, q: int, *,
              dtype=torch.float64, tf32_products: bool = False,
              block: int = 8192) -> Tuple[float, torch.Tensor]:
    """``(f, g)`` at ``theta``, summed over blocks of ``block`` rows, in
    ``dtype``; ``tf32_products``: both products take TF32-rounded operands
    (``dtype`` float32), the control's precision."""
    theta = theta.to(codes.device, dtype)
    w = weights.to(codes.device, dtype)
    lq = l * q
    h = theta[:lq]
    m = coupling_matrix(theta, l, q)
    if tf32_products:
        m = tf32(m)
    f = 0.0
    gh = torch.zeros(lq, dtype=dtype, device=codes.device)
    dm = torch.zeros((lq, lq), dtype=dtype, device=codes.device)
    for r0 in range(0, codes.shape[0], block):
        x = one_hot(codes[r0:r0 + block], q, dtype)
        logits = (x @ m + h).reshape(-1, l, q)
        lse = torch.logsumexp(logits, dim=2)
        picked = (logits.reshape(-1, lq) * x).reshape(-1, l, q).sum(dim=2)
        wb = w[r0:r0 + block]
        f += float((wb[:, None] * (lse - picked)).sum())
        g = (torch.softmax(logits, dim=2).reshape(-1, lq) - x) * wb[:, None]
        gh += g.sum(dim=0)
        dm += (tf32(g) if tf32_products else g).T @ x
        del x, logits, g
    jp = theta[lq:]
    f += lambda_h * float((h * h).sum()) + lambda_j * float((jp * jp).sum())
    grad = torch.cat([gh + 2.0 * lambda_h * h, _pair_grad(dm, l, q) + 2.0 * lambda_j * jp])
    return f, grad


def init_theta(codes: torch.Tensor, weights: torch.Tensor, l: int, q: int) -> torch.Tensor:
    """pydca's start (``plmdca_numerics.cpp:207-249``): ``h[i, a] =
    log(weighted count + 1)`` centred per site, ``J = 0``; float64."""
    w = weights.to(codes.device, torch.float64)
    counts = torch.zeros((l, q), dtype=torch.float64, device=codes.device)
    counts.scatter_add_(1, codes.long().T, w[None, :].expand(l, -1))
    h = torch.log(counts + 1.0)
    h = h - h.mean(dim=1, keepdim=True)
    theta = torch.zeros(n_params(l, q), dtype=torch.float64, device=codes.device)
    theta[: l * q] = h.reshape(-1)
    return theta


def gauge_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Coupling blocks (P, k, k) in the zero-sum gauge."""
    return (blocks - blocks.mean(dim=2, keepdim=True) - blocks.mean(dim=1, keepdim=True)
            + blocks.mean(dim=(1, 2), keepdim=True))


def gauge_fn(blocks: torch.Tensor) -> torch.Tensor:
    """Frobenius norms (P,) of zero-sum-gauge shifted blocks (P, k, k)."""
    s = gauge_blocks(blocks)
    return torch.sqrt((s * s).sum(dim=(1, 2)))


def apc(fn: torch.Tensor, l: int) -> torch.Tensor:
    """``s - av_i av_j / av``: av_i the mean score of the L-1 pairs of site
    i, av the mean of the av_i."""
    iu, ju = _pairs(l, fn.device)
    full = torch.zeros((l, l), dtype=fn.dtype, device=fn.device)
    full[iu, ju] = fn
    full[ju, iu] = fn
    av = full.sum(dim=1) / (l - 1)
    return fn - av[iu] * av[ju] / av.mean()


def fn_apc(theta: torch.Tensor, l: int, q: int) -> torch.Tensor:
    """FN-APC (P,) in pair order from the gap-free couplings of ``theta``
    (the gap is the last state), in float64."""
    jp = theta[l * q:].to(torch.float64).reshape(-1, q, q)[:, : q - 1, : q - 1]
    return apc(gauge_fn(jp), l)


def fit(codes: torch.Tensor, weights: torch.Tensor, lambda_h: float, lambda_j: float,
        l: int, q: int, *, dtype=torch.float64, tf32_products: bool = False,
        max_iterations: int = 100, epsilon: float = 1e-3, block: int = 8192) -> Fit:
    """The fit from :func:`init_theta` by :func:`.lbfgs.minimize`, every
    evaluation in ``dtype``; ``tf32_products`` (``dtype`` float32) makes it
    the control; ``epsilon`` 0 runs ``max_iterations`` iterations."""

    def fun(theta):
        return objective(theta, codes, weights, lambda_h, lambda_j, l, q, dtype=dtype,
                         tf32_products=tf32_products, block=block)

    return minimize(fun, init_theta(codes, weights, l, q).to(dtype),
                    max_iterations=max_iterations, epsilon=epsilon)
