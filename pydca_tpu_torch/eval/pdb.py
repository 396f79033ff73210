"""Minimal PDB structure handling (no Biopython).

A copy of ``pydca_tpu/eval/pdb.py`` (host code).  Parses ATOM/HETATM
records of the first model of a PDB file into per-chain residue lists with
atom names and coordinates, extracts standard-residue sequences and
classifies chains as protein or RNA — the subset of
``Bio.PDB`` behaviour the reference's evaluator uses
(``pydca/contact_visualizer/contact_visualizer.py:109-408``).
"""

from __future__ import annotations

import logging
import os
import urllib.request
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["PDBContent", "PDBContentException", "Residue", "parse_pdb_atoms"]

STANDARD_RESIDUES = {
    "RNA": ("A", "C", "G", "U"),
    "PROTEIN": (
        "ALA", "ARG", "ASN", "ASP", "CYS",
        "GLN", "GLU", "GLY", "HIS", "ILE",
        "LEU", "LYS", "MET", "PHE", "PRO",
        "SER", "THR", "TRP", "TYR", "VAL",
    ),
}

RES_THREE_CHAR_TO_ONE = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C",
    "GLN": "Q", "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I",
    "LEU": "L", "LYS": "K", "MET": "M", "PHE": "F", "PRO": "P",
    "SER": "S", "THR": "T", "TRP": "W", "TYR": "Y", "VAL": "V",
}


class PDBContentException(Exception):
    """PDB parsing/analysis errors."""


@dataclass
class Residue:
    """One residue: name, author residue number, insertion code, atoms."""

    name: str
    resseq: int
    icode: str
    hetero: bool
    atom_names: List[str] = field(default_factory=list)
    coords: List[Tuple[float, float, float]] = field(default_factory=list)

    def heavy_atoms(self) -> Tuple[List[str], np.ndarray]:
        """Atom names + (k, 3) coordinates, hydrogens excluded.

        Mirrors the reference's H filter on the atom *name* prefix
        (``contact_visualizer.py:1360``).
        """
        names, xyz = [], []
        for n, c in zip(self.atom_names, self.coords):
            if n.startswith("H"):
                continue
            names.append(n)
            xyz.append(c)
        return names, np.asarray(xyz, dtype=np.float64).reshape(-1, 3)


def parse_pdb_atoms(pdb_file: str) -> "OrderedDict[str, List[Residue]]":
    """Parse the first model of a PDB file into {chain_id: [Residue, ...]}.

    Keeps the first altloc of each atom name within a residue (Biopython
    selects by occupancy; for standard X-ray files the first conformer is
    the highest-occupancy one in practice).
    """
    chains: "OrderedDict[str, List[Residue]]" = OrderedDict()
    index: Dict[Tuple[str, int, str, str], Residue] = {}
    with open(pdb_file, "r") as fh:
        for line in fh:
            rec = line[:6]
            if rec == "ENDMDL":
                break  # first model only
            if rec not in ("ATOM  ", "HETATM"):
                continue
            atom_name = line[12:16].strip()
            altloc = line[16]
            resname = line[17:20].strip()
            chain_id = line[21]
            try:
                resseq = int(line[22:26])
            except ValueError:
                continue
            icode = line[26]
            try:
                x, y, z = float(line[30:38]), float(line[38:46]), float(line[46:54])
            except ValueError:
                continue
            hetero = rec == "HETATM"
            key = (chain_id, resseq, icode, resname)
            res = index.get(key)
            if res is None:
                res = Residue(
                    name=resname, resseq=resseq, icode=icode, hetero=hetero
                )
                index[key] = res
                chains.setdefault(chain_id, []).append(res)
            if altloc not in (" ", "A") and atom_name in res.atom_names:
                continue
            if atom_name in res.atom_names:
                continue  # first altloc wins
            res.atom_names.append(atom_name)
            res.coords.append((x, y, z))
    if not chains:
        raise PDBContentException(f"no ATOM records found in {pdb_file}")
    return chains


class PDBContent:
    """Chain sequences and residue data of a PDB file.

    Accepts a path or a bare 4-character PDB ID, in which case the file is
    downloaded from rcsb.org (``contact_visualizer.py:220-249``).
    """

    DOWNLOAD_URL = "https://files.rcsb.org/download/{}.pdb"

    def __init__(self, pdb_file: str, biomolecule: Optional[str] = None):
        self.__pdb_id = None
        if not os.path.exists(pdb_file) and len(pdb_file.strip()) == 4:
            self.__pdb_id = pdb_file.strip().lower()
            pdb_file = self.download_pdb(self.__pdb_id)
        self.__pdb_file = pdb_file
        self.__biomolecule = biomolecule.strip().upper() if biomolecule else None
        self.__chains = parse_pdb_atoms(pdb_file)
        self.__chain_sequences = self._collect_chain_sequences()

    @staticmethod
    def download_pdb(pdb_id: str) -> str:
        """Fetch a PDB file by ID into the working directory."""
        dest = f"{pdb_id}.pdb"
        if not os.path.exists(dest):
            url = PDBContent.DOWNLOAD_URL.format(pdb_id)
            logger.info("downloading %s", url)
            urllib.request.urlretrieve(url, dest)  # noqa: S310
        return dest

    # ------------------------------------------------------------- properties
    @property
    def pdb_file(self) -> str:
        return self.__pdb_file

    @property
    def pdb_id(self):
        return self.__pdb_id

    @property
    def chains(self):
        return self.__chains

    @property
    def pdb_chain_sequences(self):
        """{chain_id: (biomolecule, one-letter sequence)}."""
        return self.__chain_sequences

    # ---------------------------------------------------------------- helpers
    @staticmethod
    def filter_residues(residues: List[Residue], biomolecule: str) -> List[Residue]:
        """Standard, non-hetero residues of the given biomolecule type
        (``contact_visualizer.py:323-342``)."""
        biomolecule = biomolecule.strip().upper()
        std = STANDARD_RESIDUES[biomolecule]
        return [r for r in residues if r.name in std and not r.hetero]

    @staticmethod
    def to_sequence(residue_name_list: List[str], biomolecule: str) -> str:
        biomolecule = biomolecule.strip().upper()
        if biomolecule == "PROTEIN":
            return "".join(RES_THREE_CHAR_TO_ONE[r] for r in residue_name_list)
        return "".join(residue_name_list)

    def _collect_chain_sequences(self):
        """Classify each chain as protein or RNA and extract its sequence
        (``contact_visualizer.py:373-408``)."""
        out = OrderedDict()
        for chain_id, residues in self.__chains.items():
            biomolecule = "PROTEIN"
            std = self.filter_residues(residues, biomolecule)
            if not std:
                biomolecule = "RNA"
                std = self.filter_residues(residues, biomolecule)
            if not std:
                logger.warning(
                    "chain %s of %s has no standard residues; skipped",
                    chain_id,
                    self.__pdb_file,
                )
                continue
            seq = self.to_sequence([r.name for r in std], biomolecule)
            out[chain_id] = (biomolecule, seq)
        if not out:
            raise PDBContentException(
                f"no chain with standard residues in {self.__pdb_file}"
            )
        return out

    def standard_residues(self, chain_id: str, biomolecule: str) -> List[Residue]:
        if chain_id not in self.__chains:
            raise PDBContentException(
                f"no chain {chain_id!r} in {self.__pdb_file}; "
                f"available: {list(self.__chains)}"
            )
        return self.filter_residues(self.__chains[chain_id], biomolecule)
