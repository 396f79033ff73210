"""MSA trimming by column gap fraction or by reference sequence.

Port of ``pydca_tpu/trim.py``, a behavioural port of
``pydca/msa_trimmer/msa_trimmer.py``: operates on the RAW alignment records
(no dedup — the reference reads via ``AlignIO`` directly,
``msa_trimmer.py:39``), gap characters are '-' and '.'
(``msa_trimmer.py:86,172``), and the refseq-guided modes consult the
best-matching sequence found by the backmapper, whose template search runs
on the trimmer's ``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np

from .backmap import SequenceBackmapper
from .io.fasta import read_sequences

logger = logging.getLogger(__name__)

__all__ = ["MSATrimmer", "MSATrimmerException"]

_GAP_CHARS = ("-", ".")


class MSATrimmerException(Exception):
    """Errors raised during MSA trimming."""


class MSATrimmer:
    def __init__(
        self,
        msa_file: str,
        biomolecule: Optional[str] = None,
        max_gap: Optional[float] = None,
        refseq_file: Optional[str] = None,
        device="cuda",
    ):
        self.__msa_file = msa_file
        self.__device = device
        self.__refseq_file = refseq_file
        self.__max_gap = 0.5 if max_gap is None else float(max_gap)
        if not 0.0 <= self.__max_gap <= 1.0:
            raise MSATrimmerException("max_gap must be between 0 and 1")
        self.__biomolecule = biomolecule.strip().upper() if biomolecule else None
        ids, seqs = read_sequences(msa_file)
        self.__ids = ids
        self.__seqs = seqs

    @property
    def alignment_ids(self) -> List[str]:
        return self.__ids

    @property
    def alignment_sequences(self) -> List[str]:
        return self.__seqs

    # ------------------------------------------------------------- gap stats
    def compute_msa_columns_gap_size(self) -> Tuple[float, ...]:
        """Per-column gap fraction (``msa_trimmer.py:58-94``)."""
        arr = np.frombuffer(
            "".join(self.__seqs).encode("ascii"), dtype="S1"
        ).reshape(len(self.__seqs), -1)
        is_gap = (arr == b"-") | (arr == b".")
        return tuple(is_gap.mean(axis=0).tolist())

    def msa_columns_beyond_max_gap(self) -> Tuple[int, ...]:
        gaps = self.compute_msa_columns_gap_size()
        return tuple(i for i, g in enumerate(gaps) if g > self.__max_gap)

    def trim_by_gap_size(self) -> Tuple[int, ...]:
        """Columns whose gap fraction exceeds ``max_gap``
        (``msa_trimmer.py:120-136``)."""
        return self.msa_columns_beyond_max_gap()

    # ------------------------------------------------------------ refseq mode
    def _matching_seq(self) -> str:
        if self.__biomolecule is None or self.__refseq_file is None:
            raise MSATrimmerException(
                "trim_by_refseq requires biomolecule and refseq_file"
            )
        backmapper = SequenceBackmapper(
            msa_file=self.__msa_file,
            refseq_file=self.__refseq_file,
            biomolecule=self.__biomolecule,
            device=self.__device,
        )
        return backmapper.find_matching_seqs_from_alignment()[0]

    def trim_by_refseq(self, remove_all_gaps: bool = False) -> Tuple[int, ...]:
        """Columns to remove based on the best refseq-matching sequence.

        Default: gappy columns (> max_gap) that are also gaps in the matching
        sequence; with ``remove_all_gaps``, *every* column that is a gap in the
        matching sequence (``msa_trimmer.py:139-194``).
        """
        matching = self._matching_seq()
        if not remove_all_gaps:
            candidates = self.msa_columns_beyond_max_gap()
            return tuple(i for i in candidates if matching[i] in _GAP_CHARS)
        return tuple(
            i for i in range(len(self.__seqs[0])) if matching[i] in _GAP_CHARS
        )

    def get_msa_trimmed_by_refseq(self, remove_all_gaps: bool = False):
        """(id, trimmed_seq) list (``msa_trimmer.py:197-207``)."""
        cols = set(self.trim_by_refseq(remove_all_gaps=remove_all_gaps))
        out = []
        for sid, seq in zip(self.__ids, self.__seqs):
            out.append(
                (sid, "".join(ch for k, ch in enumerate(seq) if k not in cols))
            )
        return out
