"""Reference-sequence backmapping: MSA column index -> refseq position.

Port of ``pydca_tpu/backmap.py``, which re-implements the reference's
backmapper semantics (``pydca/sequence_backmapper/sequence_backmapper.py``)
on its own aligner (:mod:`pydca_tpu_torch.align`):

1. find the MSA sequence that best matches the reference by local alignment
   score over *every* (gap-stripped) MSA sequence: one batched search on the
   backmapper's device (``sequence_backmapper.py:231-286``),
2. locally align ref vs. that template (gaps removed) on the host,
3. re-insert the template's MSA gaps into the aligned reference portion
   (``align_subsequences``, ``sequence_backmapper.py:288-336``),
4. walk the result to produce {MSA column -> refseq position}
   (``map_to_reference_sequence``, ``sequence_backmapper.py:339-466``).

An MSA given as encoded rows (a FASTA file, or ``alignment_data`` of code
rows, as the CLIs pass it) stays in code form: its padded templates are a
stable compaction of each row's non-gap codes on the device, and only the
rows the caller reads are decoded.  ``alignment_data`` holding strings
takes the JAX package's string route.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from . import align as align_mod
from . import matrices
from .alphabets import get_alphabet
from .device import resolve_device, sync
from .io.fasta import _dedup_encoded, read_msa, read_sequences
from .profiling import StageTimers

logger = logging.getLogger(__name__)

__all__ = ["SequenceBackmapper", "templates_from_codes"]

_GAP = "-"


def templates_from_codes(codes: torch.Tensor, gap: int) -> torch.Tensor:
    """(N, W) templates from (N, L) code rows, on their device: each row's
    non-gap codes moved to the front in order, the rest ``gap``; W is the
    largest residue count of a row.  Equal to encoding each decoded row with
    its '-' removed and padding it with the gap state, which is what the
    search reads as padding."""
    keep = codes != gap
    w = int(keep.sum(dim=1).max()) if codes.shape[0] else 0
    # gap cells all land in the spare column w
    pos = torch.where(keep, keep.cumsum(dim=1) - 1, w)
    out = torch.full((codes.shape[0], w + 1), gap, dtype=codes.dtype, device=codes.device)
    out.scatter_(1, pos, codes)
    return out[:, :w]


class SequenceBackmapper:
    """Maps MSA columns onto positions of an ungapped reference sequence.

    ``device`` runs the template search: the card by default, the CPU when
    asked; a CUDA request without a card raises.  ``timers`` holds the
    stages ``read`` (decode and dedup), ``templates``, ``search``,
    ``align`` (the local alignment and its traceback) and ``map``.
    """

    def __init__(
        self,
        msa_file: Optional[str] = None,
        alignment_data=None,
        ref_seq: Optional[str] = None,
        refseq_file: Optional[str] = None,
        biomolecule: Optional[str] = None,
        device="cuda",
    ):
        if biomolecule is None:
            raise ValueError("biomolecule must be given ('protein' or 'rna')")
        self.alphabet = get_alphabet(biomolecule)
        self.device = resolve_device(device)
        self.timers = StageTimers()
        self.__codes = None  # (N, L) int8 deduplicated code rows, or None
        self.__alignment = None  # the rows as strings, decoded when read
        with self.timers.stage("read"):
            if msa_file:
                self.__codes = read_msa(msa_file, biomolecule).data
            elif alignment_data is not None:
                rows = [s.upper() if isinstance(s, str) else np.asarray(s)
                        for s in alignment_data]
                if rows and not any(isinstance(r, str) for r in rows) \
                        and len({r.shape for r in rows}) == 1:
                    self.__codes = self._checked_codes(np.stack(rows))
                else:
                    seqs = [r if isinstance(r, str) else self.alphabet.decode(r)
                            for r in rows]
                    # order-preserving dedup (sequence_backmapper.py:54-56)
                    self.__alignment = list(dict.fromkeys(seqs))
            else:
                raise ValueError("provide msa_file or alignment_data")

        if refseq_file:
            ids, seqs = read_sequences(refseq_file)
            if len(seqs) > 1:
                logger.warning(
                    "found %d reference sequences in %s; taking the first",
                    len(seqs),
                    refseq_file,
                )
            self.__ref_sequence = seqs[0].strip().upper()
        elif ref_seq:
            self.__ref_sequence = ref_seq.strip().upper()
        else:
            raise ValueError("provide ref_seq or refseq_file")
        self._validate_refseq()

        self.__submat = matrices.submatrix_for(biomolecule, self.alphabet.letters)
        self.__gap_open, self.__gap_extend = matrices.gap_penalties_for(biomolecule)

    def _checked_codes(self, codes: np.ndarray) -> np.ndarray:
        """Code rows in [0, q), deduplicated in first-seen order (decoding is
        one to one there, so this is the JAX package's dedup of the decoded
        strings).  Codes outside [0, q) raise."""
        if codes.size and (codes.min() < 0 or codes.max() >= self.alphabet.q):
            raise ValueError(f"alignment codes must lie in [0, {self.alphabet.q})")
        codes, _ = _dedup_encoded(codes.astype(np.int8), [None] * codes.shape[0])
        return codes

    # ---------------------------------------------------------------- helpers
    @property
    def alignment(self) -> List[str]:
        if self.__alignment is None:
            self.__alignment = self.alphabet.decode_many(self.__codes)
        return self.__alignment

    @property
    def ref_sequence(self) -> str:
        return self.__ref_sequence

    def _row(self, k: int) -> str:
        """Alignment row ``k`` as a string, decoding that row alone."""
        if self.__alignment is not None:
            return self.__alignment[k]
        return self.alphabet.decode(self.__codes[k])

    def _validate_refseq(self):
        """Reference sequences must be ungapped standard residues
        (``sequence_backmapper.py:127-149``)."""
        for res in self.__ref_sequence:
            if not self.alphabet.is_standard(res):
                raise ValueError(
                    "reference sequence should only contain standard residues; "
                    f"found {res!r}"
                )

    def _encode_std(self, seq: str) -> np.ndarray:
        """Encode a gap-free standard-residue string to state indices."""
        return self.alphabet.encode_str(seq).astype(np.int32)

    def align_pairs_local(self, ref_seq: str, other_seq: str, score_only=False):
        """Local alignment (score or full) with the reference's matrices."""
        a = self._encode_std(ref_seq)
        b = self._encode_std(other_seq)
        score, a_start, b_start, path = align_mod.local_align(
            a, b, self.__submat, self.__gap_open, self.__gap_extend
        )
        if score_only:
            return score
        return score, a_start, b_start, path

    # -------------------------------------------------------- template search
    def _templates(self):
        """(templates, pad value) of every alignment row for the search."""
        if self.__codes is not None:
            codes = torch.from_numpy(self.__codes).to(self.device)
            gap = self.alphabet.gap_state
            return templates_from_codes(codes, gap), gap
        stripped = [s.replace(_GAP, "") for s in self.__alignment]
        wmax = max(len(s) for s in stripped)
        pad = -1
        temps = np.full((len(stripped), wmax), pad, dtype=np.int32)
        for k, s in enumerate(stripped):
            if s:
                temps[k, : len(s)] = self._encode_std(s)
        return temps, pad

    def find_matching_seqs_from_alignment(self) -> List[str]:
        """Best-matching MSA sequences to the reference (first one is used).

        Shortcut when the first MSA sequence (gaps stripped) equals the
        reference (``sequence_backmapper.py:252-260``); otherwise one batched
        search over all sequences on the backmapper's device.
        """
        first = self._row(0)
        if first.replace(_GAP, "") == self.__ref_sequence:
            logger.info("first sequence in alignment matches reference exactly")
            return [first]

        with self.timers.stage("templates"):
            temps, pad = self._templates()
            sync(self.device)
        with self.timers.stage("search"):
            scores = align_mod.batch_local_align_scores(
                self._encode_std(self.__ref_sequence),
                temps,
                self.__submat,
                self.__gap_open,
                self.__gap_extend,
                pad,
                device=self.device,
            )
        max_score = scores.max()
        matching = [self._row(k) for k in np.nonzero(scores == max_score)[0]]
        if len(matching) > 1:
            logger.warning(
                "found %d sequences in MSA matching the reference; taking the first",
                len(matching),
            )
        return matching

    # ---------------------------------------------------------------- mapping
    @staticmethod
    def align_subsequences(
        ref_middle_subseq: str,
        template_subseq_in_msa: str,
        num_res_middle_template: int,
    ) -> str:
        """Re-insert the template's MSA gaps into the aligned ref portion.

        Behavioural port of ``sequence_backmapper.py:288-336`` including the
        early-exit boundary check.
        """
        mapped = []
        res_count = 0
        pos = 0
        for site in template_subseq_in_msa:
            if res_count == num_res_middle_template:
                break
            if site != _GAP:
                mapped.append(ref_middle_subseq[pos])
                pos += 1
                res_count += 1
                if pos == len(ref_middle_subseq):
                    break
            else:
                if ref_middle_subseq[pos] != _GAP:
                    mapped.append(_GAP)
                else:
                    mapped.append(ref_middle_subseq[pos])
                    pos += 1
        mapped.extend(list(ref_middle_subseq[pos:]))
        return "".join(mapped)

    def map_to_reference_sequence(self) -> Dict[int, int]:
        """{MSA column -> refseq position} (``sequence_backmapper.py:339-466``)."""
        template_seq_in_msa = self.find_matching_seqs_from_alignment()[0]
        template_stripped = template_seq_in_msa.replace(_GAP, "")

        with self.timers.stage("align"):
            score, ref_start, temp_start, path = self.align_pairs_local(
                self.__ref_sequence, template_stripped
            )
            ref_mid, temp_mid = align_mod.aligned_strings(
                self.__ref_sequence, template_stripped, ref_start, temp_start, path
            )
        with self.timers.stage("map"):
            mapping = self._mapping(template_seq_in_msa, ref_mid, temp_mid,
                                    ref_start, temp_start)
        logger.info(
            "mapped %d of %d reference residues",
            len(mapping),
            len(self.__ref_sequence),
        )
        return mapping

    def _mapping(self, template_seq_in_msa, ref_mid, temp_mid, ref_start, temp_start):
        """The column mapping from the local alignment of the reference with
        the template (``sequence_backmapper.py:366-466``)."""
        num_leading_res_ref = ref_start
        num_leading_res_template = temp_start
        num_res_middle_template = sum(1 for c in temp_mid if c != _GAP)

        # start of matching region within the gapped MSA template
        res_count = 0
        start_indx_in_msa = len(template_seq_in_msa)
        for k, site in enumerate(template_seq_in_msa):
            if res_count == num_leading_res_template:
                start_indx_in_msa = k
                break
            if site != _GAP:
                res_count += 1

        template_subseq_in_msa = template_seq_in_msa[start_indx_in_msa:]
        backmapped = self.align_subsequences(
            ref_mid, template_subseq_in_msa, num_res_middle_template
        )

        mapped_sites: Dict[int, int] = {}
        mapped_res_count = 0
        limit = len(template_seq_in_msa) - start_indx_in_msa
        for k, site in enumerate(backmapped):
            if k == limit:
                break
            if site != _GAP:
                mapped_sites[mapped_res_count + num_leading_res_ref] = (
                    start_indx_in_msa + k
                )
                mapped_res_count += 1
        # invert: keys = MSA columns, values = refseq positions
        return {v: k for k, v in mapped_sites.items()}
