"""Substitution matrices for pairwise alignment.

A copy of ``pydca_tpu/matrices.py`` (numpy only).  BLOSUM62 (standard
public matrix, here over the 20 standard amino acids —
MSA template sequences are gap-stripped encoded sequences so never contain
ambiguity codes) and the NUC44-style RNA matrix the reference exposes
(match 5 / mismatch -4 over ACGU; ``pydca/sequence_backmapper/scoring_matrix.py:7-12,93``).

Gap penalties used by the reference backmapper
(``sequence_backmapper.py:206-213``): protein open -10 / extend -1 with
BLOSUM62; RNA open -8 / extend 0 with NUC44.
"""

from __future__ import annotations

import numpy as np

__all__ = ["BLOSUM62", "NUC44", "submatrix_for", "gap_penalties_for"]

_AA = "ARNDCQEGHILKMFPSTWYV"

# Standard BLOSUM62, row/col order ARNDCQEGHILKMFPSTWYV.
_BLOSUM62_ROWS = [
    # A   R   N   D   C   Q   E   G   H   I   L   K   M   F   P   S   T   W   Y   V
    [ 4, -1, -2, -2,  0, -1, -1,  0, -2, -1, -1, -1, -1, -2, -1,  1,  0, -3, -2,  0],  # A
    [-1,  5,  0, -2, -3,  1,  0, -2,  0, -3, -2,  2, -1, -3, -2, -1, -1, -3, -2, -3],  # R
    [-2,  0,  6,  1, -3,  0,  0,  0,  1, -3, -3,  0, -2, -3, -2,  1,  0, -4, -2, -3],  # N
    [-2, -2,  1,  6, -3,  0,  2, -1, -1, -3, -4, -1, -3, -3, -1,  0, -1, -4, -3, -3],  # D
    [ 0, -3, -3, -3,  9, -3, -4, -3, -3, -1, -1, -3, -1, -2, -3, -1, -1, -2, -2, -1],  # C
    [-1,  1,  0,  0, -3,  5,  2, -2,  0, -3, -2,  1,  0, -3, -1,  0, -1, -2, -1, -2],  # Q
    [-1,  0,  0,  2, -4,  2,  5, -2,  0, -3, -3,  1, -2, -3, -1,  0, -1, -3, -2, -2],  # E
    [ 0, -2,  0, -1, -3, -2, -2,  6, -2, -4, -4, -2, -3, -3, -2,  0, -2, -2, -3, -3],  # G
    [-2,  0,  1, -1, -3,  0,  0, -2,  8, -3, -3, -1, -2, -1, -2, -1, -2, -2,  2, -3],  # H
    [-1, -3, -3, -3, -1, -3, -3, -4, -3,  4,  2, -3,  1,  0, -3, -2, -1, -3, -1,  3],  # I
    [-1, -2, -3, -4, -1, -2, -3, -4, -3,  2,  4, -2,  2,  0, -3, -2, -1, -2, -1,  1],  # L
    [-1,  2,  0, -1, -3,  1,  1, -2, -1, -3, -2,  5, -1, -3, -1,  0, -1, -3, -2, -2],  # K
    [-1, -1, -2, -3, -1,  0, -2, -3, -2,  1,  2, -1,  5,  0, -2, -1, -1, -1, -1,  1],  # M
    [-2, -3, -3, -3, -2, -3, -3, -3, -1,  0,  0, -3,  0,  6, -4, -2, -2,  1,  3, -1],  # F
    [-1, -2, -2, -1, -3, -1, -1, -2, -2, -3, -3, -1, -2, -4,  7, -1, -1, -4, -3, -2],  # P
    [ 1, -1,  1,  0, -1,  0,  0,  0, -1, -2, -2,  0, -1, -2, -1,  4,  1, -3, -2, -2],  # S
    [ 0, -1,  0, -1, -1, -1, -1, -2, -2, -1, -1, -1, -1, -2, -1,  1,  5, -2, -2,  0],  # T
    [-3, -3, -4, -4, -2, -2, -3, -2, -2, -3, -2, -3, -1,  1, -4, -3, -2, 11,  2, -3],  # W
    [-2, -2, -2, -3, -2, -1, -2, -3,  2, -1, -1, -2, -1,  3, -3, -2, -2,  2,  7, -2],  # Y
    [ 0, -3, -3, -3, -1, -2, -2, -3, -3,  3,  1, -2,  1, -1, -2, -2,  0, -3, -2,  4],  # V
]

BLOSUM62 = {}
for _i, _a in enumerate(_AA):
    for _j, _b in enumerate(_AA):
        BLOSUM62[(_a, _b)] = _BLOSUM62_ROWS[_i][_j]

# NUC44 as exported by the reference: ACGU only, match 5 / mismatch -4.
NUC44 = {}
for _a in "ACGU":
    for _b in "ACGU":
        NUC44[(_a, _b)] = 5 if _a == _b else -4


def submatrix_for(biomolecule: str, letters: str) -> np.ndarray:
    """Dense (len(letters), len(letters)) float32 substitution matrix."""
    table = BLOSUM62 if biomolecule.strip().upper() == "PROTEIN" else NUC44
    n = len(letters)
    m = np.zeros((n, n), dtype=np.float32)
    for i, a in enumerate(letters):
        for j, b in enumerate(letters):
            m[i, j] = table.get((a, b), table.get((b, a), -4))
    return m


def gap_penalties_for(biomolecule: str):
    """(open, extend) penalties as in ``sequence_backmapper.py:206-213``."""
    if biomolecule.strip().upper() == "PROTEIN":
        return -10.0, -1.0
    return -8.0, 0.0
