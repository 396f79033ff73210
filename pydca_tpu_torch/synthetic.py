"""Seeded synthetic alignments with planted couplings, and rank metrics.

A family is drawn from a star phylogeny: ancestors from per-column
Dirichlet profiles (with a gap share), descendants by point mutation, so
the 0.8-identity reweighting has clusters to act on.  Then disjoint site
pairs ``(i, j)`` with ``|i - j| > 4`` are planted: in each sequence, with
probability ``couple_prob``, ``s_j`` is set to ``pi_ij(s_i)`` for a fixed
random permutation ``pi_ij`` of the q states.  A plmDCA fit or a
mean-field run should rank the planted pairs near the top of its FN-APC
list.

Two family sweeps feed the family batches (``compute_fn_batch``): the JAX
package's RNA sweep (:func:`rna_family_sweep`) and planted protein
families at Pfam widths (:func:`protein_family_sweep`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .alphabets import Alphabet
from .io.fasta import write_fasta

__all__ = [
    "PLANTED_TOP",
    "PLANTED_MIN_SHARE",
    "planted_family",
    "planted_recovery",
    "protein_family_sweep",
    "reference_from_row",
    "rna_family_sweep",
    "spearman",
    "top_k_overlap",
    "write_family_fasta",
]

# A fit passes when at least PLANTED_MIN_SHARE of the planted pairs are
# among the top PLANTED_TOP FN-APC pairs.  Calibrated against the JAX
# package on CPU, for plmDCA and for mean-field DCA
# (test_planted_pairs_recovered in tests/test_torch_cli.py and
# tests/test_torch_cli_mfdca.py).
PLANTED_TOP = 40
PLANTED_MIN_SHARE = 0.9


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


def rna_family_sweep(families: int = 32, seed: int = 2) -> List[np.ndarray]:
    """The JAX package's family sweep (``bench.py:468-491``): ``families``
    RNA-like alignments (q = 5), N uniform in [64, 512] and L uniform in
    [16, 64] drawn from ``seed``, family k from 16 ancestors with 15% of
    its states redrawn (seed k).  Codes (N, L) int8 per family."""
    nmax, lmax, q = 512, 64, 5
    rng = np.random.default_rng(seed)

    def synth(n, l, k):
        r = np.random.default_rng(k)
        base = r.integers(0, q, size=(16, l))
        msa = base[r.integers(0, 16, size=n)]
        flip = r.random((n, l)) < 0.15
        return np.where(flip, r.integers(0, q, size=(n, l)), msa).astype(np.int8)

    return [
        synth(int(rng.integers(nmax // 8, nmax + 1)), int(rng.integers(lmax // 4, lmax + 1)), k)
        for k in range(families)
    ]


def protein_family_sweep(families: int = 12, seed: int = 3):
    """Planted protein families (q = 21) at Pfam widths: N log-uniform in
    [1024, 8192] and L uniform in [80, 300] drawn from ``seed``, family k
    from :func:`planted_family` with seed ``1000 * seed + k``.  Returns
    ``[(codes, planted pairs), ...]``."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(families):
        n = int(round(np.exp(rng.uniform(np.log(1024), np.log(8192)))))
        l = int(rng.integers(80, 301))
        out.append(planted_family(n, l, 21, seed=1000 * seed + k))
    return out


def reference_from_row(codes: np.ndarray, k: int, alphabet: Alphabet, *, seed: int = 0,
                       n_sub: int = 3, ends: Tuple[int, int] = (4, 4)) -> str:
    """A reference sequence made from row ``k`` of ``codes``: its residues
    with the gaps dropped, ``n_sub`` of them substituted, and ``ends``
    random residues added before and after it."""
    rng = np.random.default_rng(seed)
    r = alphabet.q - 1  # residue states
    res = codes[k][codes[k] != alphabet.gap_state].astype(np.int64)
    at = rng.choice(len(res), size=n_sub, replace=False)
    res[at] = (res[at] + rng.integers(1, r, size=n_sub)) % r
    head, tail = (rng.integers(0, r, size=e) for e in ends)
    return alphabet.decode(np.concatenate([head, res, tail]))


def write_family_fasta(path: str, codes: np.ndarray, alphabet: Alphabet) -> None:
    """Write ``codes`` as a FASTA alignment (ids ``seq0``, ``seq1``, ...)."""
    seqs = alphabet.decode_many(codes)
    write_fasta(path, [f"seq{k}" for k in range(len(seqs))], seqs)


def planted_recovery(sorted_scores, pairs: Sequence[Tuple[int, int]],
                     top: int = PLANTED_TOP) -> float:
    """Share of the planted pairs among the ``top`` ranked pairs
    (``sorted_scores``: ``[((i, j), score), ...]``, 0-based, descending)."""
    best = {tuple(p) for p, _ in sorted_scores[:top]}
    return sum(tuple(p) in best for p in pairs) / len(pairs)


def _dense(sorted_scores, l: int) -> np.ndarray:
    """Sorted ``[((i, j), s), ...]`` -> scores in pair order ``(P,)``."""
    out = np.full(l * (l - 1) // 2, np.nan)
    for (i, j), s in sorted_scores:
        out[l * (l - 1) // 2 - (l - i) * (l - i - 1) // 2 + j - i - 1] = s
    return out


def spearman(a_sorted, b_sorted, l: int) -> float:
    """Spearman rank correlation of two sorted score lists over all pairs."""
    a, b = _dense(a_sorted, l), _dense(b_sorted, l)
    ra = np.argsort(np.argsort(a)).astype(float)
    rb = np.argsort(np.argsort(b)).astype(float)
    ra -= ra.mean()
    rb -= rb.mean()
    return float((ra * rb).sum() / np.sqrt((ra ** 2).sum() * (rb ** 2).sum()))


def top_k_overlap(a_sorted, b_sorted, k: int) -> float:
    """Share of the top-``k`` pairs the two sorted lists have in common."""
    a = {tuple(p) for p, _ in a_sorted[:k]}
    b = {tuple(p) for p, _ in b_sorted[:k]}
    return len(a & b) / k
