"""Drop-in compatibility shim for ``pydca.fasta_reader.fasta_reader``.

The port's copy of ``pydca_tpu/fasta_reader.py`` over the port's reader
(the port imports nothing of the JAX package).

The reference exposes a module-level functional API with **1-based** residue
codes and ``gap = q`` (``pydca/fasta_reader/fasta_reader.py:34-45``).  This
framework's internal encoding is 0-based with ``gap = q - 1``
(:mod:`pydca_tpu_torch.alphabets`); the shim converts at the boundary so reference
user code keeps working unchanged:

    from pydca_tpu_torch import fasta_reader
    seqs = fasta_reader.get_alignment_int_form("msa.fa", biomolecule="rna")

Semantics mirrored from the reference:
- sequences upper-cased, blank records dropped (``fasta_reader.py:103-106``),
- non-standard residues map to the gap state (``fasta_reader.py:143-151``),
- duplicate sequences dropped after encoding, first occurrence kept
  (``fasta_reader.py:153``).
"""

from __future__ import annotations

import logging
from typing import List

from .alphabets import get_alphabet
from .io.fasta import read_msa, read_sequences

logger = logging.getLogger(__name__)

__all__ = [
    "RES_TO_INT_ALL",
    "FastaReaderError",
    "res_to_char",
    "get_alignment_from_fasta_file",
    "alignment_letter2int",
    "get_alignment_int_form",
    "get_alignment_char_form",
    "sequences_to_char_form",
]

# Same tables as the reference (fasta_reader.py:34-45): 1-based, gap = q.
RES_TO_INT_ALL = {
    "PROTEIN": {
        **{ch: i + 1 for i, ch in enumerate("ACDEFGHIKLMNPQRSTVWY")},
        "-": 21,
        ".": 21,
        "~": 21,
    },
    "RNA": {"A": 1, "C": 2, "G": 3, "U": 4, "-": 5, ".": 5, "~": 5},
}


class FastaReaderError(Exception):
    """Raised for alignment-reading failures (reference ``fasta_reader.py:48``)."""


def res_to_char(biomolecule: str) -> dict:
    """Inverse mapping int -> char; gap renders as ``'-'``
    (reference ``fasta_reader.py:53-76``)."""
    biomolecule = biomolecule.strip().upper()
    return {
        val: key
        for key, val in RES_TO_INT_ALL[biomolecule].items()
        if key not in (".", "~")
    }


def get_alignment_from_fasta_file(file_name: str) -> List[str]:
    """Read upper-cased sequence strings from a FASTA file
    (reference ``fasta_reader.py:79-119``; own parser, wrapped lines ok)."""
    try:
        _, seqs = read_sequences(file_name)
    except OSError:
        raise
    except Exception as exc:
        raise FastaReaderError(
            f"error reading FASTA file {file_name}: {exc}"
        ) from exc
    return seqs


def alignment_letter2int(alignment, biomolecule: str = "protein") -> List[List[int]]:
    """Encode char sequences to 1-based int lists, dropping duplicates
    (reference ``fasta_reader.py:122-163``)."""
    biomolecule = biomolecule.strip().upper()
    if biomolecule not in ("PROTEIN", "RNA"):
        raise ValueError("Biomolecule must be either PROTEIN or RNA")
    alphabet = get_alphabet(biomolecule)
    out: List[List[int]] = []
    seen = set()
    for seq in alignment:
        enc = alphabet.encode_str(str(seq))
        key = enc.tobytes()
        if key in seen:
            continue
        seen.add(key)
        out.append([int(x) + 1 for x in enc])
    if not out:
        raise ValueError("No data found in alignment in integer representation")
    return out


def get_alignment_int_form(file_name: str, biomolecule: str = "protein"):
    """Read + encode + dedup, 1-based codes (reference ``fasta_reader.py:166-188``)."""
    msa = read_msa(file_name, biomolecule)
    return [[int(x) + 1 for x in row] for row in msa.data]


def get_alignment_char_form(file_name: str, biomolecule: str = "PROTEIN"):
    """Deduplicated sequences re-rendered as chars, gaps normalized to ``'-'``
    (reference ``fasta_reader.py:191-224``)."""
    msa = read_msa(file_name, biomolecule)
    return msa.char_form()


def sequences_to_char_form(seqs_lst, biomolecule: str):
    """Convert 1-based int sequences back to char strings
    (reference ``fasta_reader.py:227-249``)."""
    mapping = res_to_char(biomolecule)
    return ["".join(mapping[int(r)] for r in seq) for seq in seqs_lst]
