"""Output utilities: ranked-score writer, CSV parameter and frequency dumps,
header blocks.

Copy of the writers of ``pydca_tpu/io/output.py`` that the ported
subcommands use, which replicate the reference's output formats exactly
(``pydca/dca_utilities/dca_utilities.py``): site pairs are written
1-indexed and files carry ``#`` metadata headers.  :func:`write_params`
writes ``compute_params``' two files and :func:`write_batch_scores`
``compute_fn_batch``'s, for both CLIs; the last three writers are the
``pydca`` CLI's (TP rates, contact categories, trimmed MSA).
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence

import numpy as np

from ..alphabets import get_alphabet

logger = logging.getLogger(__name__)

__all__ = [
    "create_directories",
    "get_dca_output_file_path",
    "mfdca_param_metadata",
    "plmdca_param_metadata",
    "residue_repr_metadata",
    "write_sorted_dca_scores",
    "write_couplings_csv",
    "write_fields_csv",
    "write_params",
    "write_batch_scores",
    "write_single_site_freqs",
    "write_pair_site_freqs",
    "write_sequence_weights",
    "write_tp_rate",
    "write_contact_map",
    "write_trimmed_msa",
]

_RULE = "#" + "=" * 70


def create_directories(the_path: str) -> None:
    """mkdir -p  (``dca_utilities.py:9-26``)."""
    os.makedirs(the_path, exist_ok=True)


def get_dca_output_file_path(
    output_dir: str, msa_file_name: str, prefix: str = "", postfix: str = ""
) -> str:
    """Build ``output_dir/<prefix><msa-stem><postfix>`` (``dca_utilities.py:29-56``)."""
    root, _ = os.path.splitext(os.path.basename(msa_file_name))
    return os.path.join(output_dir, prefix.strip() + root.strip() + postfix.strip())


def mfdca_param_metadata(inst) -> List[str]:
    """Header block for mfDCA outputs (``dca_utilities.py:109-137``): six
    spaces of indentation, not a tab, and an Meff line."""
    return [
        "# PARAMETERS USED FOR THIS COMPUTATION: ",
        "#      Sequence type: {}".format(inst.biomolecule),
        "#      Total number of sequences in alignment data: {}".format(
            inst.num_sequences
        ),
        "#      Length of sequences in alignment data: {}".format(inst.sequences_len),
        "#      Effective number of sequences: {}".format(
            inst.effective_num_sequences
        ),
        "#      Value of sequence identity: {}".format(inst.sequence_identity),
        "#      Value of relative pseudocount: {}".format(inst.pseudocount),
    ]


def plmdca_param_metadata(inst) -> List[str]:
    """Header block for plmDCA outputs (``dca_utilities.py:140-169``)."""
    return [
        "# PARAMETERS USED FOR THIS COMPUTATION: ",
        "#\tSequence type: {}".format(inst.biomolecule),
        "#\tTotal number of sequences in alignment data: {}".format(
            inst.num_sequences
        ),
        "#\tLength of sequences in alignment data: {}".format(inst.sequences_len),
        "#\tValue of sequence identity: {}".format(inst.sequence_identity),
        "#\tlambda_h: {}".format(inst.lambda_h),
        "#\tlambda_J: {}".format(inst.lambda_J),
        "#\tNumber of gradient decent iterations: {}".format(inst.max_iterations),
    ]


def residue_repr_metadata(biomolecule: str) -> List[str]:
    """Residue int<->char mapping header (``dca_utilities.py:172-201``).

    The reference writes 1-based codes; we keep that external convention.
    """
    alphabet = get_alphabet(biomolecule)
    pairs = [(i + 1, ch) for i, ch in enumerate(alphabet.letters)]
    pairs.append((alphabet.q, "-"))
    lines = ["# RESIDUES IDENTIFICATION"]
    for r in range(len(pairs) // 5 + 1):
        row = pairs[r * 5 : (r + 1) * 5]
        if not row and r > 0:
            continue
        lines.append("# " + "".join(str(p) for p in row))
    return lines


def write_sorted_dca_scores(
    file_name: str,
    sorted_di,
    metadata: Optional[List[str]] = None,
    score_type: Optional[str] = None,
) -> None:
    """Ranked score writer, 1-indexed ``i j score`` (``dca_utilities.py:236-266``)."""
    logger.info("writing DCA scores to %s", file_name)
    with open(file_name, "w") as fh:
        fh.write(_RULE + "\n")
        if metadata:
            for line in metadata:
                fh.write(f"{line}\n")
        fh.write(
            "# The First and Second columns represent sites and the"
            "\n# Third column is {} DCA score\n".format(score_type)
        )
        fh.write(_RULE + "\n")
        for (i, j), score in sorted_di:
            fh.write("{0:<7} {1:<14} {2:<35}\n".format(i + 1, j + 1, score))


def write_couplings_csv(file_name, couplings, metadata=None) -> None:
    """Per-pair coupling rows ``i,j,J_11,...`` (``dca_utilities.py:293-327``)."""
    with open(file_name, "w") as fh:
        fh.write(_RULE + "\n")
        if metadata:
            for line in metadata:
                fh.write(f"{line}\n")
            fh.write(_RULE + "\n")
        for (i, j), cij in couplings:
            fh.write(f"{i + 1},{j + 1}")
            for c in cij:
                fh.write(f",{c}")
            fh.write("\n")


def write_fields_csv(file_name, fields, metadata=None) -> None:
    """Per-site field rows ``i,h_1,...`` (``dca_utilities.py:330-359``)."""
    with open(file_name, "w") as fh:
        fh.write(_RULE + "\n")
        if metadata is not None:
            for line in metadata:
                fh.write(f"{line}\n")
            fh.write(_RULE + "\n")
        for site, site_fields in fields:
            fh.write(f"{site + 1}")
            for f in site_fields:
                fh.write(f",{f}")
            fh.write("\n")


def write_params(
    fields_file, couplings_file, fields, couplings, metadata,
    ranked_by=None, linear_dist=None,
) -> None:
    """``compute_params``' two files: the fields and the ranked couplings,
    each under ``metadata`` and its own count lines
    (``pydca_tpu/cli/mfdca_main.py:198-234``,
    ``pydca_tpu/cli/plmdca_main.py:233-265``)."""
    meta = list(metadata)
    meta.append(
        "#\tTotal number of sites whose fields are extracted: {}".format(len(fields))
    )
    write_fields_csv(fields_file, fields, metadata=meta)
    meta = list(metadata)
    meta.append(
        "#\tTotal number of site pairs whose couplings are extracted: {}".format(
            len(couplings)
        )
    )
    meta.append("#\tDCA ranking method used: {}".format((ranked_by or "FN_APC").upper()))
    meta.append(
        "#\tMinimum separation beteween site pairs in sequence: |i - j| > {}".format(
            linear_dist if linear_dist is not None else 4
        )
    )
    write_couplings_csv(couplings_file, couplings, metadata=meta)


def write_batch_scores(output_dir, msa_files, msas, scores_per_family, prefix,
                       score_type) -> List[str]:
    """``compute_fn_batch``'s files: one ranked score file per family, each
    under a header that says the family was computed in a batch
    (``pydca_tpu/cli/plmdca_main.py:318-344``,
    ``pydca_tpu/cli/mfdca_main.py:306-332``).  Returns the paths."""
    paths = []
    for msa_file, msa, scores in zip(msa_files, msas, scores_per_family):
        meta = [
            "# PARAMETERS USED FOR THIS COMPUTATION: ",
            "#      Sequence type: {}".format(msa.alphabet.name),
            "#      Total number of sequences in alignment data: {}".format(msa.num_seqs),
            "#      Length of sequences in alignment data: {}".format(msa.seqs_len),
            "#      Computed in a family batch of {} MSAs".format(len(msas)),
        ]
        path = get_dca_output_file_path(output_dir, msa_file, prefix=prefix, postfix=".txt")
        write_sorted_dca_scores(path, scores, metadata=meta, score_type=score_type)
        paths.append(path)
    return paths


def write_single_site_freqs(
    file_name, fi, seqs_len: int, num_site_states: int, metadata=None
) -> None:
    """``i,a,freq`` rows, 1-indexed (``dca_utilities.py:362-395``)."""
    fi = np.asarray(fi)
    with open(file_name, "w") as fh:
        fh.write(_RULE + "\n")
        if metadata:
            for line in metadata:
                fh.write(f"{line}\n")
            fh.write(
                "# Below, the First integer refers to the site, the \n"
                "# Second the residue at that site, and the Third is the \n"
                "# frequency. Residue numbers are mapped as shown above.\n"
            )
            fh.write(_RULE + "\n")
        for i in range(seqs_len):
            for a in range(num_site_states):
                fh.write(f"{i + 1},{a + 1},{fi[i, a]}\n")


def write_sequence_weights(file_name, weights, ids=None, metadata=None) -> None:
    """Per-sequence reweighting factors: ``index,weight[,id]`` rows, 1-indexed.

    The reference computes and exposes weights (engine property,
    ``meanfield_dca.py:186-233``) but never dumps them; this writer closes
    that gap (VERDICT r2) so Meff debugging doesn't require the Python API.
    """
    weights = np.asarray(weights)
    with open(file_name, "w") as fh:
        fh.write(_RULE + "\n")
        if metadata:
            for line in metadata:
                fh.write(f"{line}\n")
        fh.write(
            "# Below, the First integer is the sequence index in the\n"
            "# (deduplicated) alignment, the Second its reweighting factor\n"
            "# 1/m (m = #sequences with identity > seqid), then the\n"
            "# sequence identifier when available.\n"
        )
        fh.write(_RULE + "\n")
        for k, w in enumerate(weights):
            if ids is not None and k < len(ids):
                fh.write(f"{k + 1},{w},{ids[k]}\n")
            else:
                fh.write(f"{k + 1},{w}\n")


def write_pair_site_freqs(
    file_name, fij, seqs_len: int, num_site_states: int, metadata=None
) -> None:
    """``i,j,a,b,freq`` rows, gaps excluded (``dca_utilities.py:398-436``)."""
    fij = np.asarray(fij)
    with open(file_name, "w") as fh:
        fh.write(_RULE + "\n")
        if metadata:
            for line in metadata:
                fh.write(f"{line}\n")
            fh.write(
                "# Below, the First and Second integers refer to sites, the \n"
                "# Third and Fourth residues, and the Last one is frequency for pairs.\n"
                "# Residue numbers are mapped as shown above.\n"
            )
            fh.write(_RULE + "\n")
        pc = 0
        for i in range(seqs_len - 1):
            for j in range(i + 1, seqs_len):
                for a in range(num_site_states - 1):
                    for b in range(num_site_states - 1):
                        fh.write(f"{i + 1},{j + 1},{a + 1},{b + 1},{fij[pc, a, b]}\n")
                pc += 1


def write_tp_rate(file_name, true_positive_rates_dict=None, metadata=None) -> None:
    """Two-column DCA/PDB TP-rate file (``dca_utilities.py:506-535``)."""
    dca = true_positive_rates_dict["dca"]
    pdb = true_positive_rates_dict["pdb"]
    with open(file_name, "w") as fh:
        fh.write(_RULE + "\n")
        for line in metadata or []:
            fh.write(f"{line}\n")
        fh.write(_RULE + "\n")
        for d, p in zip(dca, pdb):
            fh.write("{0:.6f}\t{1:.6f}\n".format(d, p))


def write_contact_map(file_name, contact_categories_dict, metadata=None) -> None:
    """Categorized contact list (``dca_utilities.py:538-578``)."""
    describe = [
        "# Column-1 :  contact category",
        "# Column-2 : site-number in sequence (first pairing site)",
        "# Column-3 : site-number in sequence (second pairing site)",
        "# Column-4 : closest atom pairs for residue pairs",
        "# Column-5 : site-number in PDB (first pairing site)",
        "# Column-6 : site-number in PDB (second pairing site)",
        "# Column-7 : distance between pairing atoms (column-4) in Angstrom",
    ]
    metadata = list(metadata or []) + describe
    with open(file_name, "w") as fh:
        fh.write(_RULE + "\n")
        for line in metadata:
            fh.write(f"{line}\n")
        fh.write(_RULE + "\n")
        for category, pairs in contact_categories_dict.items():
            for pair, pdb_meta in pairs.items():
                line = [category] + list(pair) + list(pdb_meta)
                fh.write("\t\t".join(str(e) for e in line) + "\n")


def write_trimmed_msa(
    file_name, ids: Sequence[str], seqs: Sequence[str], columns_to_remove
) -> None:
    """Write MSA with the given columns removed (``dca_utilities.py:581-607``)."""
    cols = set(int(c) for c in columns_to_remove)
    with open(file_name, "w") as fh:
        for sid, seq in zip(ids, seqs):
            trimmed = "".join(ch for k, ch in enumerate(seq) if k not in cols)
            fh.write(f">{sid}\n{trimmed}\n")
