"""FASTA MSA ingestion.

Port of ``pydca_tpu/io/fasta.py``.  A self-contained FASTA parser: handles
wrapped sequence lines, upper-cases residues, drops duplicate sequences
while preserving first-seen order, and encodes to an ``(N, L)`` int8 array
with 0-based states and ``gap = q - 1``.  :func:`read_msa` reads through
the native C++ codec (:mod:`pydca_tpu_torch.native.fastacodec`, built with
``g++`` at first use) and falls back to the Python path, with a warning,
where there is no compiler or the codec fails.

Behaviour matches the reference reader (``pydca/fasta_reader/fasta_reader.py``):
- sequences are read in file order and upper-cased (``fasta_reader.py:103-106``),
- non-standard residues map to the gap state (``fasta_reader.py:143-151``),
- duplicates are removed *after* encoding, keeping the first occurrence
  (``fasta_reader.py:153``).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..alphabets import Alphabet, get_alphabet

logger = logging.getLogger(__name__)

__all__ = [
    "MSA",
    "parse_fasta",
    "read_msa",
    "read_sequences",
    "write_fasta",
]


class FastaError(Exception):
    """Raised for malformed FASTA input."""


@dataclass
class MSA:
    """An encoded multiple sequence alignment.

    Attributes
    ----------
    data : np.ndarray
        ``(N, L)`` int8 array, 0-based states, gap = ``alphabet.gap_state``.
    alphabet : Alphabet
        The residue alphabet used for encoding.
    ids : list[str] | None
        FASTA record ids for the retained (deduplicated) sequences.
    """

    data: np.ndarray
    alphabet: Alphabet
    ids: Optional[List[str]] = None

    @property
    def num_seqs(self) -> int:
        return self.data.shape[0]

    @property
    def seqs_len(self) -> int:
        return self.data.shape[1]

    @property
    def q(self) -> int:
        return self.alphabet.q

    def char_form(self) -> List[str]:
        return self.alphabet.decode_many(self.data)

    def __repr__(self):
        return (
            f"MSA(num_seqs={self.num_seqs}, seqs_len={self.seqs_len}, "
            f"alphabet={self.alphabet.name})"
        )


def parse_fasta(text: str) -> Tuple[List[str], List[str]]:
    """Parse FASTA text into (ids, sequences).

    Handles line-wrapped sequences; blank lines are ignored.  Records with
    empty sequences are dropped (mirrors ``fasta_reader.py:105-106``).
    """
    ids: List[str] = []
    seqs: List[str] = []
    cur_id: Optional[str] = None
    cur_chunks: List[str] = []

    def flush():
        nonlocal cur_id, cur_chunks
        if cur_id is not None:
            seq = "".join(cur_chunks).strip()
            if seq:
                ids.append(cur_id)
                seqs.append(seq.upper())
        cur_id, cur_chunks = None, []

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            flush()
            cur_id = line[1:].strip()
        elif line.startswith(";"):
            continue  # old-style comment lines
        else:
            if cur_id is None:
                raise FastaError("sequence data before first '>' header")
            cur_chunks.append(line)
    flush()

    if not seqs:
        raise FastaError("no sequences found in FASTA input")
    return ids, seqs


def read_sequences(file_name: str) -> Tuple[List[str], List[str]]:
    """Read raw (ids, upper-cased sequence strings) from a FASTA file."""
    with open(file_name, "r") as fh:
        return parse_fasta(fh.read())


def _dedup_encoded(
    data: np.ndarray, ids: List[str]
) -> Tuple[np.ndarray, List[str]]:
    """Drop duplicate rows keeping first occurrence (stable order).

    The reference dedups on the *encoded* form, i.e. after mapping
    non-standard residues to gap (``fasta_reader.py:143-153``).
    """
    # np.unique sorts; recover first-seen order via the index of the first
    # occurrence of each unique row.  Each row is viewed as one opaque byte
    # string, which finds the same rows as np.unique(axis=0).
    rows = np.ascontiguousarray(data).view(np.dtype((np.void, data.shape[1] * data.itemsize)))
    _, first_idx = np.unique(rows.ravel(), return_index=True)
    keep = np.sort(first_idx)
    if keep.size == data.shape[0]:
        return data, ids
    return data[keep], [ids[i] for i in keep]


def read_msa(
    file_name: str,
    biomolecule: str,
    *,
    dedup: bool = True,
    keep_ids: bool = True,
) -> MSA:
    """Read and encode an MSA FASTA file.

    Parameters
    ----------
    file_name : str
        Path to the FASTA file.
    biomolecule : str
        ``"protein"`` or ``"rna"``.
    dedup : bool
        Drop duplicate sequences (first occurrence kept).  Default True,
        matching the reference reader.
    """
    alphabet = get_alphabet(biomolecule)
    native = _get_native_codec()
    if native is not None:
        try:
            data, ids = native.read_and_encode(file_name, alphabet, dedup=dedup)
            return MSA(data=data, alphabet=alphabet, ids=ids if keep_ids else None)
        except Exception as exc:  # the Python path reads it, or raises its own error
            logger.warning("native FASTA codec failed (%s); using the Python path", exc)
    ids, seqs = read_sequences(file_name)
    lengths = {len(s) for s in seqs}
    if len(lengths) != 1:
        raise FastaError(
            f"alignment sequences have differing lengths {sorted(lengths)} "
            f"in {file_name}"
        )
    data = alphabet.encode_many(seqs)
    if dedup:
        data, ids = _dedup_encoded(data, ids)
    return MSA(data=data, alphabet=alphabet, ids=ids if keep_ids else None)


def write_fasta(file_name: str, ids: Sequence[str], seqs: Sequence[str]) -> None:
    """Write sequences to a FASTA file, one line per sequence."""
    os.makedirs(os.path.dirname(os.path.abspath(file_name)), exist_ok=True)
    with open(file_name, "w") as fh:
        for sid, seq in zip(ids, seqs):
            fh.write(f">{sid}\n{seq}\n")


# ----------------------------------------------------------------- native hook
_NATIVE = None
_NATIVE_CHECKED = False


def _get_native_codec():
    """The native FASTA codec module, built at the first call; ``None``
    (warned once) where it cannot be built."""
    global _NATIVE, _NATIVE_CHECKED
    if _NATIVE_CHECKED:
        return _NATIVE
    _NATIVE_CHECKED = True
    from ..native import fastacodec

    if fastacodec.available():
        _NATIVE = fastacodec
    else:
        logger.warning("native FASTA codec unavailable (no g++ or a failed build); "
                       "reading FASTA with the Python path")
    return _NATIVE
