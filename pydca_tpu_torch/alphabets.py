"""Residue alphabets and integer encodings for protein and RNA MSAs.

Internally this framework uses **0-based** state codes with the gap as the
*last* state (``gap = q - 1``).  This differs from the reference pydca, which
uses 1-based codes with ``gap = q`` (``pydca/fasta_reader/fasta_reader.py:34-45``);
subtracting 1 from a reference code gives ours, so statistics and score
orderings are directly comparable.  Non-standard residues map to the gap state,
matching the reference behaviour (``fasta_reader.py:143-151``).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "Alphabet",
    "PROTEIN",
    "RNA",
    "get_alphabet",
]


class Alphabet:
    """An ordered residue alphabet with a trailing gap state.

    Attributes
    ----------
    name : str
        ``"PROTEIN"`` or ``"RNA"``.
    letters : str
        The residue characters in state order (gap excluded).
    q : int
        Number of states including the gap (protein 21, RNA 5).
    gap_state : int
        Integer code of the gap state (always ``q - 1``).
    """

    GAP_CHARS = "-.~"

    def __init__(self, name: str, letters: str):
        self.name = name
        self.letters = letters
        self.q = len(letters) + 1
        self.gap_state = self.q - 1
        # char -> int lookup table over all 256 byte values; unknown chars,
        # lowercase of unknown chars, and explicit gap chars map to gap_state.
        table = np.full(256, self.gap_state, dtype=np.uint8)
        for i, ch in enumerate(letters):
            table[ord(ch)] = i
            table[ord(ch.lower())] = i
        self._encode_table = table
        # int -> char (gap renders as '-')
        self._decode_table = np.frombuffer(
            (letters + "-").encode("ascii"), dtype=np.uint8
        ).copy()

    # ------------------------------------------------------------------ encode
    def encode_str(self, seq: str) -> np.ndarray:
        """Encode one sequence string to an int8 state vector."""
        raw = np.frombuffer(seq.encode("ascii", errors="replace"), dtype=np.uint8)
        return self._encode_table[raw].astype(np.int8)

    def encode_many(self, seqs) -> np.ndarray:
        """Encode a list of equal-length sequence strings to an (N, L) int8 array."""
        if not seqs:
            raise ValueError("empty sequence list")
        joined = "".join(seqs)
        raw = np.frombuffer(joined.encode("ascii", errors="replace"), dtype=np.uint8)
        enc = self._encode_table[raw].astype(np.int8)
        L = len(seqs[0])
        if enc.size != len(seqs) * L:
            raise ValueError("sequences have unequal lengths")
        return enc.reshape(len(seqs), L)

    # ------------------------------------------------------------------ decode
    def decode(self, states: np.ndarray) -> str:
        """Decode an int state vector back to a residue string (gap -> '-')."""
        arr = np.asarray(states, dtype=np.int64).ravel()
        return self._decode_table[arr].tobytes().decode("ascii")

    def decode_many(self, states: np.ndarray):
        arr = np.asarray(states, dtype=np.int64)
        return [self.decode(row) for row in arr]

    def is_standard(self, ch: str) -> bool:
        """True if ``ch`` is one of the standard (non-gap) residue letters."""
        return ch.upper() in self.letters

    def __repr__(self):
        return f"Alphabet({self.name!r}, q={self.q})"


# Reference state order (minus one): pydca/fasta_reader/fasta_reader.py:34-45.
PROTEIN = Alphabet("PROTEIN", "ACDEFGHIKLMNPQRSTVWY")
RNA = Alphabet("RNA", "ACGU")

_BY_NAME = {"PROTEIN": PROTEIN, "RNA": RNA}


def get_alphabet(biomolecule: str) -> Alphabet:
    """Look up the alphabet for ``"protein"`` or ``"rna"`` (case-insensitive)."""
    key = biomolecule.strip().upper()
    if key not in _BY_NAME:
        raise ValueError(
            f"Unknown biomolecule {biomolecule!r}; must be 'protein' or 'rna'"
        )
    return _BY_NAME[key]
