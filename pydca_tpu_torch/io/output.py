"""Output utilities: ranked-score writer and the mfDCA / plmDCA header blocks.

Port of the ``compute_fn`` part of ``pydca_tpu/io/output.py``, which
replicates the reference's output formats exactly
(``pydca/dca_utilities/dca_utilities.py``): site pairs are written
1-indexed and files carry ``#`` metadata headers.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

logger = logging.getLogger(__name__)

__all__ = [
    "create_directories",
    "get_dca_output_file_path",
    "mfdca_param_metadata",
    "plmdca_param_metadata",
    "write_sorted_dca_scores",
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
