"""Dense linear algebra for the mean-field solve.

Port of ``pydca_tpu/ops/linalg.py::spd_inverse``.  The JAX package's
divide-and-conquer triangular inverse (``tri_inv_lower``), blocked
Cholesky (``cholesky_blocked``) and sharded SYRK (``syrk_sharded``) exist
for the TPU's matrix unit and its mesh; on one card the inverse is the
library's Cholesky factorisation and Cholesky inverse.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["spd_inverse"]


def spd_inverse(c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of a symmetric positive-definite matrix, and the factor's ``info``.

    ``C = L L^T`` by ``torch.linalg.cholesky_ex``, ``C^{-1}`` by
    ``torch.cholesky_inverse``, then symmetrised as
    ``pydca_tpu/ops/linalg.py:216`` does.  Returns ``(inverse, info)``:
    ``info`` is a 0-d int32 tensor on ``c.device``, 0 when the factorisation
    succeeded.  A failed factorisation raises nothing and yields no NaNs
    as it does under jit; the caller reads ``info`` (with its other
    results, in one fetch) and then discards the inverse.
    """
    chol, info = torch.linalg.cholesky_ex(c)
    # A failed factor may hold a zero pivot, on which cholesky_inverse
    # raises on the CPU; set its diagonal to ones (O(D), no host sync) so
    # the call completes and returns the garbage the caller discards.
    diag = chol.diagonal()
    diag.copy_(torch.where(info == 0, diag, torch.ones_like(diag)))
    inv = torch.cholesky_inverse(chol)
    del chol
    # symmetrise: removes accumulation-order asymmetry
    return (inv + inv.mT).mul_(0.5), info
