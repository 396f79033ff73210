"""Contact-map / true-positive-rate evaluator.

A copy of ``pydca_tpu/eval/visualizer.py`` (host code, numpy; matplotlib
is imported only inside the plot methods).  Behavioural port of the
reference's evaluator
(``pydca/contact_visualizer/contact_visualizer.py``) on top of our own PDB
parser and aligner: reference-sequence content, RNA dot-bracket secondary
structure, ranked DCA-pair ingestion, refseq<->PDB-chain mapping by local
alignment, all-pair minimum heavy-atom distances (vectorized NumPy instead of
the reference's O(#res^2 #atoms^2) Python loop, ``contact_visualizer.py:1300-1372``),
tp/fp/missing/pdb contact categorization, matplotlib contact maps and
TP-rate-per-rank curves.
"""

from __future__ import annotations

import itertools
import logging
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import align as align_mod
from .. import matrices
from ..alphabets import get_alphabet
from ..io.fasta import read_sequences
from .pdb import PDBContent, STANDARD_RESIDUES, RES_THREE_CHAR_TO_ONE

logger = logging.getLogger(__name__)

__all__ = [
    "RefSeqContent",
    "RNASecStructContent",
    "DCAContent",
    "DCAVisualizer",
    "DCAVisualizerException",
    "is_protein_sequence",
    "is_rna_sequence",
]

_PROTEIN_ONE = tuple(RES_THREE_CHAR_TO_ONE.values())


def is_protein_sequence(seq: str) -> bool:
    """True if every residue is a standard one-letter amino acid
    (``contact_visualizer.py:42-60``)."""
    return all(r in _PROTEIN_ONE for r in seq.strip().upper())


def is_rna_sequence(seq: str) -> bool:
    """True if every residue is A/C/G/U (``contact_visualizer.py:63-82``)."""
    return all(r in STANDARD_RESIDUES["RNA"] for r in seq.strip().upper())


class RefSeqContentException(Exception):
    pass


class RefSeqContent:
    """Reference sequences from a FASTA file, typed protein/RNA
    (``contact_visualizer.py:438-574``)."""

    def __init__(self, refseq_file: str, biomolecule: Optional[str] = None):
        self.__refseq_file = refseq_file
        self.__biomolecule = biomolecule.strip().upper() if biomolecule else None
        _, seqs = read_sequences(refseq_file)
        out = OrderedDict()
        for k, seq in enumerate(seqs, start=1):
            out[k] = (self.identify_seq_type(seq), seq)
        if not out:
            raise RefSeqContentException(f"no sequences in {refseq_file}")
        self.__sequences = out

    @property
    def ref_sequences(self):
        return self.__sequences

    @staticmethod
    def identify_seq_type(seq: str) -> str:
        """RNA if ACGU-only, else protein if standard AAs, else error
        (``contact_visualizer.py:546-574``: RNA is checked first)."""
        seq = seq.strip().upper()
        if is_rna_sequence(seq):
            return "RNA"
        if is_protein_sequence(seq):
            return "PROTEIN"
        raise RefSeqContentException(
            "sequence is neither protein nor RNA (non-standard residues?)"
        )


class RNASecStructContentException(Exception):
    pass


class RNASecStructContent:
    """Dot-bracket RNA secondary structure -> Watson-Crick pair list
    (``contact_visualizer.py:581-768``)."""

    LEFT_BRACKETS = "([{<"
    RIGHT_BRACKETS = ")]}>"
    NONWC_SYMBOLS = ".,:_-"

    def __init__(self, secstruct_file: str):
        self.__secstruct_file = secstruct_file
        self.__secstruct = self.read_rna_secstruct()
        self.__wcpairs = self.get_wcpair_indices(self.__secstruct)

    @property
    def secstruct_file(self):
        return self.__secstruct_file

    @property
    def secstruct(self):
        return self.__secstruct

    @property
    def wcpairs(self):
        return self.__wcpairs

    def read_rna_secstruct(self) -> Tuple[str, ...]:
        secstruct_str = None
        with open(self.__secstruct_file) as fh:
            for line in fh:
                line = line.strip()
                if line.startswith("#") or not line:
                    continue
                secstruct_str = line
                break
        if not secstruct_str:
            raise RNASecStructContentException(
                f"no secondary structure in {self.__secstruct_file}"
            )
        allowed = set(self.LEFT_BRACKETS + self.RIGHT_BRACKETS + self.NONWC_SYMBOLS)
        for ch in secstruct_str:
            if ch not in allowed:
                raise RNASecStructContentException(
                    f"{ch!r} is an invalid secondary-structure symbol"
                )
        return tuple(secstruct_str)

    def get_wcpair_indices(self, secstruct_data) -> Tuple[Tuple[int, int], ...]:
        """Bracket-stack pairing, 0-based indices, sorted by opening index."""
        stack: List[int] = []
        pairs: List[Tuple[int, int]] = []
        for k, symbol in enumerate(secstruct_data):
            if symbol in self.LEFT_BRACKETS:
                stack.append(k)
            elif symbol in self.RIGHT_BRACKETS:
                if not stack:
                    raise RNASecStructContentException(
                        "invalid secondary structure: unbalanced brackets"
                    )
                pairs.append((stack.pop(), k))
        if stack:
            raise RNASecStructContentException(
                "invalid secondary structure: unbalanced brackets"
            )
        pairs.sort(key=lambda x: x[0])
        return tuple(pairs)


class DCAContentException(Exception):
    pass


class DCAContent:
    """Ranked DCA site pairs from an output file or an in-memory score list,
    shifted to 0-based (``contact_visualizer.py:776-922``)."""

    def __init__(self, dca_file: Optional[str] = None, sorted_dca_scores=None):
        self.__dca_file = dca_file
        if dca_file is not None:
            pairs = self._read_dca_ranked_pairs(dca_file)
        elif sorted_dca_scores is not None:
            pairs = [
                (int(p[0]), int(p[1])) for p, _ in sorted_dca_scores
            ]  # already 0-based
        else:
            raise DCAContentException("provide dca_file or sorted_dca_scores")
        self.__dca_ranked_pairs = tuple(pairs)

    @staticmethod
    def _read_dca_ranked_pairs(dca_file: str):
        pairs = []
        with open(dca_file) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                cols = line.split()
                i, j = int(cols[0]), int(cols[1])
                pairs.append((i - 1, j - 1))  # file is 1-indexed
        if not pairs:
            raise DCAContentException(f"no DCA pairs found in {dca_file}")
        return pairs

    @property
    def dca_ranked_pairs(self):
        return self.__dca_ranked_pairs

    @property
    def num_dca_ranked_pairs(self):
        return len(self.__dca_ranked_pairs)


class DCAVisualizerException(Exception):
    pass


class DCAVisualizer:
    """Compares DCA-ranked site pairs with PDB chain contacts.

    Defaults mirror the reference: ``linear_dist=4``, ``contact_dist=8.0``
    Angstrom, ``num_dca_contacts=len(refseq)`` (``contact_visualizer.py:976-1039``).
    """

    def __init__(
        self,
        biomolecule: str,
        pdb_chain_id: str,
        pdb_file: str,
        refseq_file: Optional[str] = None,
        dca_file: Optional[str] = None,
        sorted_dca_scores=None,
        rna_secstruct_file: Optional[str] = None,
        linear_dist: Optional[int] = None,
        contact_dist: Optional[float] = None,
        num_dca_contacts: Optional[int] = None,
        wc_neighbor_dist: Optional[int] = None,
        pdb_id: Optional[str] = None,
    ):
        self.__biomolecule = biomolecule.strip().upper()
        if self.__biomolecule not in ("PROTEIN", "RNA"):
            raise DCAVisualizerException(
                f"invalid biomolecule {biomolecule!r}; must be protein or rna"
            )
        self.__pdb_file = pdb_file
        self.__pdb_content = PDBContent(pdb_file, biomolecule=self.__biomolecule)
        self.__pdb_chain_id = pdb_chain_id.strip().upper()
        self.__linear_dist = 4 if linear_dist is None else int(linear_dist)
        if self.__linear_dist < 0:
            raise DCAVisualizerException("linear_dist cannot be negative")
        self.__contact_dist = 8.0 if contact_dist is None else float(contact_dist)
        if self.__contact_dist < 0:
            raise DCAVisualizerException("contact_dist cannot be negative")
        self.__refseq_content = (
            RefSeqContent(refseq_file, biomolecule=self.__biomolecule)
            if refseq_file
            else None
        )
        if dca_file is not None:
            self.__dca_content = DCAContent(dca_file=dca_file)
        elif sorted_dca_scores is not None:
            self.__dca_content = DCAContent(sorted_dca_scores=sorted_dca_scores)
        else:
            self.__dca_content = None
        if rna_secstruct_file is not None:
            self.__rna_secstruct_content = RNASecStructContent(rna_secstruct_file)
            self.__wc_neighbor_dist = (
                0 if wc_neighbor_dist is None else int(wc_neighbor_dist)
            )
            if self.__wc_neighbor_dist < 0:
                raise DCAVisualizerException("wc_neighbor_dist cannot be negative")
        else:
            self.__rna_secstruct_content = None
            self.__wc_neighbor_dist = None
        self.__refseq_len = len(self.get_matching_refseq_to_biomolecule())
        if num_dca_contacts is None:
            self.__num_dca_contacts = self.__refseq_len
        else:
            if (
                self.__dca_content is not None
                and num_dca_contacts > self.__dca_content.num_dca_ranked_pairs
            ):
                raise DCAVisualizerException(
                    f"only {self.__dca_content.num_dca_ranked_pairs} DCA pairs "
                    f"available; requested {num_dca_contacts}"
                )
            self.__num_dca_contacts = int(num_dca_contacts)
        self.__pdb_id = pdb_id
        if (
            self.__biomolecule == "RNA"
            and self.__refseq_content
            and self.__rna_secstruct_content
        ):
            if self.__refseq_len != len(self.__rna_secstruct_content.secstruct):
                raise DCAVisualizerException(
                    "RNA secondary structure and reference sequence lengths differ"
                )

    # ------------------------------------------------------------- properties
    @property
    def biomolecule(self):
        return self.__biomolecule

    @property
    def contact_dist(self):
        return self.__contact_dist

    @property
    def linear_dist(self):
        return self.__linear_dist

    @property
    def wc_neighbor_dist(self):
        return self.__wc_neighbor_dist

    @property
    def pdb_id(self):
        return self.__pdb_id

    @property
    def pdb_chain_id(self):
        return self.__pdb_chain_id

    @property
    def pdb_content(self):
        return self.__pdb_content

    @property
    def refseq_content(self):
        return self.__refseq_content

    @property
    def rna_secstruct_content(self):
        return self.__rna_secstruct_content

    @property
    def dca_content(self):
        return self.__dca_content

    # --------------------------------------------------------------- mapping
    def get_matching_refseq_to_biomolecule(self) -> str:
        """First reference sequence whose type matches the biomolecule
        (``contact_visualizer.py:1146-1169``)."""
        if self.__refseq_content is None:
            raise DCAVisualizerException("no reference sequence supplied")
        for _, (seq_type, seq) in self.__refseq_content.ref_sequences.items():
            if seq_type == self.__biomolecule:
                return seq
        raise DCAVisualizerException(
            f"no reference sequence of type {self.__biomolecule}"
        )

    def _encode(self, seq: str) -> np.ndarray:
        return get_alphabet(self.__biomolecule).encode_str(seq).astype(np.int32)

    def align_refseq_and_pdbseq(self):
        """Local alignment of refseq vs the PDB chain sequence; returns
        (score, ref_start, pdb_start, path) (``contact_visualizer.py:1172-1245``)."""
        ref_seq = self.get_matching_refseq_to_biomolecule()
        try:
            biomol_info, pdb_seq = self.__pdb_content.pdb_chain_sequences[
                self.__pdb_chain_id
            ]
        except KeyError:
            raise DCAVisualizerException(
                f"no chain {self.__pdb_chain_id!r} in {self.__pdb_file}"
            )
        if self.__biomolecule != biomol_info:
            raise DCAVisualizerException(
                f"chain {self.__pdb_chain_id} does not contain "
                f"{self.__biomolecule} residues"
            )
        if len(ref_seq) < len(pdb_seq):
            logger.warning(
                "reference sequence is shorter than the PDB chain sequence"
            )
        alphabet = get_alphabet(self.__biomolecule)
        submat = matrices.submatrix_for(self.__biomolecule, alphabet.letters)
        go, ge = matrices.gap_penalties_for(self.__biomolecule)
        score, a0, b0, path = align_mod.local_align(
            self._encode(ref_seq), self._encode(pdb_seq), submat, go, ge
        )
        return ref_seq, pdb_seq, score, a0, b0, path

    def map_pdbseq_to_refseq(self):
        """{pdb residue index -> refseq position} plus refseq positions with
        no PDB residue (``contact_visualizer.py:1248-1297``)."""
        ref_seq, pdb_seq, score, a0, b0, path = self.align_refseq_and_pdbseq()
        mapped: "OrderedDict[int, int]" = OrderedDict()
        not_in_pdb: List[int] = list(range(a0))  # unaligned refseq prefix
        ref_pos, pdb_pos = a0, b0
        for da, db in path:
            if da and db:
                mapped[pdb_pos] = ref_pos
            elif da and not db:
                not_in_pdb.append(ref_pos)
            ref_pos += da
            pdb_pos += db
        not_in_pdb.extend(range(ref_pos, len(ref_seq)))  # unaligned suffix
        return mapped, not_in_pdb

    # --------------------------------------------------------------- contacts
    def get_mapped_pdb_contacts(self):
        """All residue pairs with min heavy-atom distance metadata, keyed by
        refseq site pairs (``contact_visualizer.py:1300-1372``).

        Fully vectorized two-stage segment reduction (no per-residue-pair
        Python loop): stage 1 reduces an all-atom distance block to per
        (atom, residue) minima via residue-segment argmins; stage 2 reduces
        over each residue's atom rows.  O(A^2) numpy work in ~128 MB blocks
        (A = total heavy atoms), then one cheap dict-building pass —
        tractable at 1000-residue chains where the previous per-pair loop
        was quadratic Python.

        Returns (mapped_residues, residues_not_found_in_pdb); values are
        ``(atom_pair, res_id_1, res_id_2, min_dist)``.
        """
        residues = self.__pdb_content.standard_residues(
            self.__pdb_chain_id, self.__biomolecule
        )
        mapping, not_in_pdb = self.map_pdbseq_to_refseq()
        names_per_res, coords_per_res, resids = [], [], []
        for res in residues:
            names, xyz = res.heavy_atoms()
            names_per_res.append(names)
            coords_per_res.append(xyz)
            resids.append(res.resseq)
        n_res = len(residues)
        counts = np.array([c.shape[0] for c in coords_per_res], dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        a_total = int(offsets[-1])
        mapped_residues: Dict[Tuple[int, int], tuple] = {}
        if n_res == 0 or a_total == 0:
            return mapped_residues, not_in_pdb
        all_xyz = np.concatenate(
            [c for c in coords_per_res if len(c)]
        ).astype(np.float32)
        all_names = [nm for names in names_per_res for nm in names]
        ne = np.nonzero(counts > 0)[0]  # residues with atoms

        # Stage 1: per atom row a, per residue j: min_b d2(a, b in j) and its
        # argmin atom.  The inner loop is over residues (O(n_res) iterations
        # of vectorized work), not residue pairs.
        m1 = np.full((a_total, n_res), np.inf, np.float32)
        g1 = np.zeros((a_total, n_res), np.int64)
        row_chunk = max(1, (1 << 25) // max(a_total, 1))  # ~128 MB f32 blocks
        for lo in range(0, a_total, row_chunk):
            hi = min(lo + row_chunk, a_total)
            diff = all_xyz[lo:hi, None, :] - all_xyz[None, :, :]
            d2 = np.einsum("abk,abk->ab", diff, diff)
            rows = np.arange(hi - lo)
            for j in ne:
                seg = d2[:, offsets[j] : offsets[j + 1]]
                arg = seg.argmin(axis=1)
                m1[lo:hi, j] = seg[rows, arg]
                g1[lo:hi, j] = offsets[j] + arg

        # Stage 2: per residue i: reduce over its atom rows.
        dmin = np.full((n_res, n_res), np.inf, np.float32)
        atom_i = np.zeros((n_res, n_res), np.int64)
        atom_j = np.zeros((n_res, n_res), np.int64)
        cols = np.arange(n_res)
        for i in ne:
            rows = m1[offsets[i] : offsets[i + 1]]  # (ci, n_res)
            ai = rows.argmin(axis=0)  # (n_res,)
            dmin[i] = rows[ai, cols]
            atom_i[i] = offsets[i] + ai
            atom_j[i] = g1[offsets[i] + ai, cols]

        # Dict building: only i < j with both residues mapped and non-empty.
        in_map = np.zeros(n_res, bool)
        in_map[[k for k in ne if int(k) in mapping]] = True
        iu, ju = np.triu_indices(n_res, k=1)
        sel = in_map[iu] & in_map[ju]
        dists = np.sqrt(dmin[iu[sel], ju[sel]].astype(np.float64))
        for i, j, dist in zip(iu[sel], ju[sel], dists):
            atom_pair = (
                all_names[atom_i[i, j]] + "-" + all_names[atom_j[i, j]]
            )
            mapped_residues[(mapping[int(i)], mapping[int(j)])] = (
                atom_pair,
                resids[i],
                resids[j],
                float(dist),
            )
        return mapped_residues, not_in_pdb

    def get_wc_pairs_and_neighbors(self):
        """WC pairs plus the (2d+1)^2 neighborhood of each
        (``contact_visualizer.py:1375-1436``)."""
        out: List[Tuple[int, int]] = []
        if not self.__rna_secstruct_content:
            logger.warning("no RNA secondary structure; cannot obtain WC pairs")
            return out
        d = self.__wc_neighbor_dist
        for first, second in self.__rna_secstruct_content.wcpairs:
            first_subsites, second_subsites = [], []
            for i in range(-d, d + 1):
                left, right = first + i, second + i
                if 0 <= left < self.__refseq_len:
                    first_subsites.append(left)
                if 0 <= right < self.__refseq_len:
                    second_subsites.append(right)
            out.extend(itertools.product(first_subsites, second_subsites))
        return out

    def dca_ranked_pairs_filtered_by_linear_dist(self, num_dca_contacts=None):
        """Top-N DCA pairs with |i-j| > linear_dist
        (``contact_visualizer.py:1490-1526``)."""
        if num_dca_contacts is None:
            num_dca_contacts = self.__num_dca_contacts
        all_pairs = self.__dca_content.dca_ranked_pairs
        if self.__linear_dist == 0:
            return tuple(all_pairs[:num_dca_contacts])
        filtered = [p for p in all_pairs if abs(p[0] - p[1]) > self.__linear_dist]
        return tuple(filtered[:num_dca_contacts])

    def contact_categories(self):
        """tp/fp/missing/pdb categorization (``contact_visualizer.py:1560-1623``)."""
        mapped_pdb_contacts, missing_residues = self.get_mapped_pdb_contacts()
        top_pairs = self.dca_ranked_pairs_filtered_by_linear_dist()
        missing_dca_contacts = [
            p
            for p in top_pairs
            if p[0] in missing_residues or p[1] in missing_residues
        ]
        contacts_in_pdb = OrderedDict(
            (p, m)
            for p, m in mapped_pdb_contacts.items()
            if m[-1] < self.__contact_dist
        )
        true_positives, false_positives = OrderedDict(), OrderedDict()
        for p in top_pairs:
            meta = mapped_pdb_contacts.get(p)
            if meta is None:
                continue
            if meta[-1] < self.__contact_dist:
                true_positives[p] = meta
            elif p not in missing_dca_contacts:
                false_positives[p] = meta
        missing_filtered = OrderedDict(
            (p, p)
            for p in missing_dca_contacts
            if abs(p[0] - p[1]) > self.__linear_dist
        )
        return {
            "tp": true_positives,
            "fp": false_positives,
            "missing": missing_filtered,
            "pdb": contacts_in_pdb,
        }

    # ------------------------------------------------------------------ plots
    @staticmethod
    def split_and_shift_contact_pairs(pairs):
        xdata = [p[0] + 1 for p in pairs]
        ydata = [p[1] + 1 for p in pairs]
        return xdata, ydata

    def _check_enough_pdb_contacts(self, pdb_contacts):
        filtered = [
            p
            for p in pdb_contacts
            if abs(p[1] - p[0]) > self.__linear_dist
        ]
        if self.__num_dca_contacts > len(filtered):
            raise DCAVisualizerException(
                f"maximum number of PDB contacts with linear distance "
                f"{self.__linear_dist} is {len(filtered)}; set the number of "
                f"DCA contacts to at most this value"
            )

    def plot_contact_map(self, show: bool = True, save_path: Optional[str] = None):
        """Contact-map scatter plot; returns the contact-categories dict
        (``contact_visualizer.py:1626-1859``)."""
        import matplotlib

        if not show:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        cats = self.contact_categories()
        tp, fp = cats["tp"], cats["fp"]
        missing, pdb_contacts = cats["missing"], cats["pdb"]
        self._check_enough_pdb_contacts(pdb_contacts)

        num_compared = len(tp) + len(fp)
        frac_tp = len(tp) / num_compared if num_compared else 0.0
        fig, ax = plt.subplots(ncols=1, nrows=1, figsize=(5, 5))
        if missing:
            xm, ym = self.split_and_shift_contact_pairs(missing)
            ax.scatter(ym, xm, s=6, color="blue", label="missing in PDB")
        xp, yp = self.split_and_shift_contact_pairs(pdb_contacts)
        ax.scatter(xp, yp, s=6, color="grey", label=f"PDB contacts ({self.__pdb_id})")
        xf, yf = self.split_and_shift_contact_pairs(fp)
        ax.scatter(yf, xf, s=6, color="red", label="false positives")
        title = (
            f"Maximum PDB contact distance : {self.__contact_dist} Angstrom\n"
            f"Minimum residue chain distance: {self.__linear_dist} residues\n"
            f"Number of DCA contacts : {self.__num_dca_contacts}\n"
            f"Fraction of true positives : {frac_tp:.3g}\n"
        )
        if self.__biomolecule == "RNA" and self.__rna_secstruct_content:
            wc_pairs = self.__rna_secstruct_content.wcpairs
            top_ranked = OrderedDict(list(tp.items()) + list(fp.items()))
            predicted_wc = OrderedDict(
                (p, v) for p, v in top_ranked.items() if p in wc_pairs
            )
            predicted_non_wc = OrderedDict(
                (p, v) for p, v in top_ranked.items() if p not in predicted_wc
            )
            tp_non_wc = OrderedDict(
                (p, v) for p, v in predicted_non_wc.items() if p not in fp
            )
            cats["tp-wc"] = predicted_wc
            cats["tp-nwc"] = tp_non_wc
            cats.pop("tp", None)
            xn, yn = self.split_and_shift_contact_pairs(tp_non_wc)
            ax.scatter(yn, xn, s=6, color="green", label="predicted Non-WC contacts")
            xw, yw = self.split_and_shift_contact_pairs(predicted_wc)
            ax.scatter(yw, xw, s=6, color="black", label="predicted WC contacts")
            title += f"Correctly predicted WC pairs : {len(predicted_wc)}\n"
            title += (
                f"Correctly predicted non-WC pairs: "
                f"{len(predicted_non_wc) - len(fp)}"
            )
        else:
            xt, yt = self.split_and_shift_contact_pairs(tp)
            ax.scatter(yt, xt, s=6, color="green", label="true positives")
        ax.set_title(title, fontsize=8)
        ax.set_xlabel("residue position", fontsize=14)
        ax.set_ylabel("residue position", fontsize=14)
        plt.tight_layout()
        if save_path:
            plt.savefig(save_path, dpi=300)
        if show:
            plt.show()
        plt.close(fig)
        return cats

    # --------------------------------------------------------------- TP rates
    def compute_true_positive_rates(self):
        """TP rate per rank for DCA and ideal-PDB orderings
        (``contact_visualizer.py:1862-1920``)."""
        max_num = int(0.5 * self.__refseq_len * self.__refseq_len)
        all_dca = self.dca_ranked_pairs_filtered_by_linear_dist(
            num_dca_contacts=max_num
        )
        pdb_content, missing = self.get_mapped_pdb_contacts()
        filtered_pdb = OrderedDict(
            (p, m)
            for p, m in pdb_content.items()
            if abs(p[0] - p[1]) > self.__linear_dist and m[3] < self.__contact_dist
        )
        num_pdb = len(filtered_pdb)
        num_tps = 0
        dca_rates, pdb_rates = [], []
        for counter, pair in enumerate(all_dca, start=1):
            if pair in filtered_pdb:
                num_tps += 1
            dca_rates.append(num_tps / counter)
            pdb_rates.append(1.0 if counter <= num_pdb else num_pdb / counter)
        return {"dca": dca_rates, "pdb": pdb_rates}

    def plot_true_positive_rates(
        self, show: bool = True, save_path: Optional[str] = None
    ):
        """TP-rate-per-rank curve with log-scaled rank axis
        (``contact_visualizer.py:1923-1966``)."""
        import matplotlib

        if not show:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        rates = self.compute_true_positive_rates()
        ranks = [i + 1 for i in range(len(rates["dca"]))]
        fig, ax = plt.subplots(nrows=1, ncols=1, figsize=(5, 5))
        ax.plot(ranks, rates["dca"])
        ax.plot(ranks, rates["pdb"])
        ax.set_xscale("log")
        title = (
            "True Positive Rate Per Rank\n"
            f"PDB cut-off distance : {self.__contact_dist} Angstrom\n"
            f"Residue chain distance : {self.__linear_dist}\n"
        )
        if self.__biomolecule == "RNA":
            title += f"WC neighbour distance : {self.__wc_neighbor_dist}\n"
        ax.set_title(title, fontsize=8)
        ax.set_xlabel("rank (log scalled)", fontsize=14)
        ax.set_ylabel("true positives/rank", fontsize=14)
        plt.grid()
        plt.tight_layout()
        if save_path:
            plt.savefig(save_path, dpi=300)
        if show:
            plt.show()
        plt.close(fig)
        return rates
