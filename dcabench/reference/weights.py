"""Sequence weights: ``w_n = 1 / #{m : identity(n, m) > float32(seqid * L)}``,
the identity counting every position whose two states (gap included) are
equal, each row its own neighbour (pydca's
``msa_numerics.py:41-49``, with the float32 threshold both packages
compare against)."""

from __future__ import annotations

import numpy as np
import torch

from . import one_hot


def identity_counts(codes: torch.Tensor, seqid: float, q: int, block: int = 4096) -> torch.Tensor:
    """(N,) int64 neighbour counts, from float32 one-hot products in blocks
    of rows (0/1 products, sums at most L: exact)."""
    n, l = codes.shape
    thr = float(np.float32(float(seqid) * l))
    x = one_hot(codes, q, torch.float32)
    out = torch.empty(n, dtype=torch.int64, device=codes.device)
    for r0 in range(0, n, block):
        out[r0:r0 + block] = ((x[r0:r0 + block] @ x.T) > thr).sum(dim=1)
    return out


def sequence_weights(codes: torch.Tensor, seqid: float, q: int) -> torch.Tensor:
    """(N,) float32 weights ``1 / count``."""
    return 1.0 / identity_counts(codes, seqid, q).to(torch.float32)
