"""Mean-field DCA in plain PyTorch (pydca's ``meanfield_dca.py``): the
weighted frequencies, their pseudocount, the correlation matrix ``C`` over
the gap-free states (the gap is the last state), the couplings
``-C^{-1}`` and FN-APC."""

from __future__ import annotations

import torch

from . import one_hot, tf32
from .plm import apc, gauge_fn


def couplings(codes: torch.Tensor, weights: torch.Tensor, q: int, pseudocount: float = 0.5, *,
              dtype=torch.float64, tf32_products: bool = False,
              block: int = 8192) -> torch.Tensor:
    """``-C^{-1}``, (L(q-1), L(q-1)), in ``dtype``; the Gram summed over
    blocks of ``block`` rows.  ``tf32_products``: the Gram takes
    TF32-rounded operands (``dtype`` float32), the control's precision."""
    n, l = codes.shape
    lq, qm1 = l * q, q - 1
    w = weights.to(codes.device, dtype)
    gram = torch.zeros((lq, lq), dtype=dtype, device=codes.device)
    for r0 in range(0, n, block):
        x = one_hot(codes[r0:r0 + block], q, dtype)
        xw = x * w[r0:r0 + block, None]
        if tf32_products:
            xw = tf32(xw)
        gram += xw.T @ x
        del x, xw
    gram /= w.sum()
    g4 = gram.reshape(l, q, l, q)
    fi = torch.diagonal(g4, dim1=0, dim2=2).diagonal(dim1=0, dim2=1)  # (L, q): g4[i, a, i, a]
    fi_r = pseudocount / q + (1.0 - pseudocount) * fi[:, :qm1]  # (L, q-1)
    fij_r = pseudocount / (q * q) + (1.0 - pseudocount) * g4[:, :qm1, :, :qm1]
    c = fij_r - fi_r[:, :, None, None] * fi_r[None, None, :, :]
    idx = torch.arange(l, device=codes.device)
    c[idx, :, idx, :] = torch.diag_embed(fi_r) - fi_r[:, :, None] * fi_r[:, None, :]
    c = c.reshape(l * qm1, l * qm1)
    del gram, g4, fij_r
    factor = torch.linalg.cholesky(c)
    return -torch.cholesky_inverse(factor)


def fn_apc(coupling_matrix: torch.Tensor, l: int, q: int) -> torch.Tensor:
    """FN-APC (P,) in pair order from the (L(q-1), L(q-1)) couplings, in
    float64."""
    qm1 = q - 1
    j4 = coupling_matrix.to(torch.float64).reshape(l, qm1, l, qm1)
    iu, ju = torch.triu_indices(l, l, offset=1, device=j4.device)
    return apc(gauge_fn(j4[iu, :, ju, :]), l)
