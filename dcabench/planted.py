"""The traffic generator's families: a frozen copy of the port's planted
alignments.

Copied from ``pydca_tpu_torch/synthetic.py:48-101`` (``_sample_columns``,
``_disjoint_pairs``, ``planted_family``), so that a later change to the
program cannot change the benchmark's inputs.

A family is drawn from a star phylogeny: ancestors from per-column
Dirichlet profiles (with a gap share; the gap is the last state), then
descendants by point mutation, so the 0.8-identity reweighting has
clusters to act on.  Then disjoint site pairs ``(i, j)`` with
``|i - j| > 4`` are planted: in each sequence, with probability
``couple_prob``, ``s_j`` is set to ``pi_ij(s_i)`` for a fixed random
permutation ``pi_ij`` of the q states.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _sample_columns(rng, cdf: np.ndarray, n: int) -> np.ndarray:
    """(n, L) states drawn column-wise from the cumulative profiles (L, q)."""
    u = rng.random((n, cdf.shape[0], 1))
    return np.minimum((u > cdf[None]).sum(axis=-1), cdf.shape[1] - 1)


def _disjoint_pairs(rng, l: int, n_pairs: int, min_sep: int = 5):
    cols = rng.permutation(l)
    used: set = set()
    pairs: List[Tuple[int, int]] = []
    for a in cols:
        if len(pairs) == n_pairs:
            break
        if a in used:
            continue
        for b in cols:
            if b not in used and b != a and abs(int(a) - int(b)) >= min_sep:
                pairs.append((int(min(a, b)), int(max(a, b))))
                used.update((a, b))
                break
    if len(pairs) < n_pairs:
        raise ValueError(f"cannot place {n_pairs} disjoint pairs in L={l}")
    return sorted(pairs)


def planted_family(
    n: int,
    l: int,
    q: int,
    *,
    seed: int = 0,
    n_pairs: int = 20,
    n_ancestors: int = 64,
    mutation: float = 0.15,
    couple_prob: float = 0.9,
    gap_share: float = 0.1,
    concentration: float = 0.5,
):
    """``(codes (n, l) int8 in [0, q), planted pairs [(i, j), ...])``."""
    rng = np.random.default_rng(seed)
    prof = rng.dirichlet(np.full(q - 1, concentration), size=l) * (1.0 - gap_share)
    prof = np.concatenate([prof, np.full((l, 1), gap_share)], axis=1)
    cdf = np.cumsum(prof, axis=1)
    ancestors = _sample_columns(rng, cdf, n_ancestors)
    codes = ancestors[rng.integers(0, n_ancestors, size=n)]
    mut = rng.random((n, l)) < mutation
    codes = np.where(mut, _sample_columns(rng, cdf, n), codes)
    pairs = _disjoint_pairs(rng, l, n_pairs)
    for i, j in pairs:
        perm = rng.permutation(q)
        sel = rng.random(n) < couple_prob
        codes[sel, j] = perm[codes[sel, i]]
    return codes.astype(np.int8), pairs

