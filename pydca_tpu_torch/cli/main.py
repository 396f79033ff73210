"""``pydca`` entry point of the port — visualization, PDB content, MSA trimming.

Port of ``pydca_tpu/cli/main.py`` (which mirrors the reference CLI,
``pydca/main.py``): subcommands ``plot_contact_map``, ``plot_tp_rate``,
``pdb_content``, ``trim_by_refseq``, ``trim_by_gap_size``; output naming
``contact_map<pdb>.txt``, ``TPR_<pdb>.txt``, ``Trimmed_<msa>.fa``
(``main.py:360-420``), plus ``--device {cuda,cpu}`` on ``trim_by_refseq``,
whose template search runs there (default cuda; no fallback to cpu).

Run as ``python -m pydca_tpu_torch.cli.main trim_by_refseq protein <msa>
<refseq> --device cuda``.
"""

from __future__ import annotations

import argparse
import os

from ..config_log import configure_logging
from ..io import output as dca_utilities
from ..trim import MSATrimmer


def get_dcavisualizer_metadata(viz):
    """Header block for visualizer outputs (``dca_utilities.py:466-503``)."""
    return [
        "# PARAMETES USED FOR THIS COMPUTATION",
        "#\tMinimum PDB contact distance : {}".format(viz.contact_dist),
        "#\tLinear distance between residues in chain > : {}".format(
            viz.linear_dist
        ),
        "#\tWC neighbor distance (if RNA) : {}".format(viz.wc_neighbor_dist),
        "#\tBIOMOLECULE : {}".format(viz.biomolecule),
        "#\tPDB-ID : {}".format(viz.pdb_id),
        "#\tPDB-CHAIN-ID : {}".format(viz.pdb_chain_id),
        "# First and Second columns are the positions of contacting residues in",
        "# referece sequence. The Third column is an annotation of contact",
        "# category. The categories can be:",
        "# tp->true posiitve, fp->false positives, pdb->PDB contacts,",
        "# missing->missing in PDB chain, tp-wc->true positive and WC pair (RNA)",
        "# tp-nwc->true positive and non-WC (RNA)",
    ]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="pydca",
        description=(
            "DCA contact-map visualization, PDB inspection, and MSA trimming "
            "(pydca_tpu_torch, PyTorch/CUDA)"
        ),
    )
    subparsers = parser.add_subparsers(dest="the_command", required=True)

    for name in ("plot_contact_map", "plot_tp_rate"):
        sp = subparsers.add_parser(name)
        sp.add_argument("biomolecule", choices=["protein", "PROTEIN", "rna", "RNA"])
        sp.add_argument("pdb_chain_id")
        sp.add_argument("pdb_file")
        sp.add_argument("refseq_file")
        sp.add_argument("dca_file")
        sp.add_argument("--rna_secstruct_file")
        sp.add_argument("--linear_dist", type=int)
        sp.add_argument("--contact_dist", type=float)
        sp.add_argument("--num_dca_contacts", type=int)
        sp.add_argument("--wc_neighbor_dist", type=int)
        sp.add_argument("--pdb_id")
        sp.add_argument("--output_dir")
        sp.add_argument("--verbose", action="store_true")
        sp.add_argument(
            "--no_show",
            action="store_true",
            help="do not open a plot window; write the figure to the output dir",
        )

    sp = subparsers.add_parser("pdb_content")
    sp.add_argument("pdb_file")
    sp.add_argument("--verbose", action="store_true")

    sp = subparsers.add_parser("trim_by_refseq")
    sp.add_argument("biomolecule", choices=["protein", "PROTEIN", "rna", "RNA"])
    sp.add_argument("msa_file")
    sp.add_argument("refseq_file")
    sp.add_argument("--max_gap", type=float)
    sp.add_argument("--remove_all_gaps", action="store_true")
    sp.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="device of the template search (default cuda; no fallback to cpu)",
    )
    sp.add_argument("--output_dir")
    sp.add_argument("--verbose", action="store_true")

    sp = subparsers.add_parser("trim_by_gap_size")
    sp.add_argument("msa_file")
    sp.add_argument("--max_gap", type=float)
    sp.add_argument("--output_dir")
    sp.add_argument("--verbose", action="store_true")
    return parser


def execute_from_command_line(
    the_command=None,
    msa_file=None,
    biomolecule=None,
    refseq_file=None,
    verbose=False,
    output_dir=None,
    pdb_file=None,
    pdb_chain_id=None,
    dca_file=None,
    rna_secstruct_file=None,
    linear_dist=None,
    contact_dist=None,
    num_dca_contacts=None,
    wc_neighbor_dist=None,
    pdb_id=None,
    max_gap=None,
    remove_all_gaps=False,
    no_show=False,
    device="cuda",
):
    if verbose:
        configure_logging()

    if the_command in ("plot_contact_map", "plot_tp_rate"):
        from ..eval.visualizer import DCAVisualizer

        viz = DCAVisualizer(
            biomolecule,
            pdb_chain_id,
            pdb_file,
            refseq_file=refseq_file,
            dca_file=dca_file,
            rna_secstruct_file=rna_secstruct_file,
            linear_dist=linear_dist,
            contact_dist=contact_dist,
            num_dca_contacts=num_dca_contacts,
            wc_neighbor_dist=wc_neighbor_dist,
            pdb_id=pdb_id,
        )
        metadata = get_dcavisualizer_metadata(viz)
        base = os.path.splitext(os.path.basename(pdb_file))[0]
        if the_command == "plot_contact_map":
            if not output_dir:
                output_dir = "contact_map_" + base
            dca_utilities.create_directories(output_dir)
            fig_path = (
                os.path.join(output_dir, f"contact_map_{base}.png")
                if no_show
                else None
            )
            cats = viz.plot_contact_map(show=not no_show, save_path=fig_path)
            path = dca_utilities.get_dca_output_file_path(
                output_dir, pdb_file, prefix="contact_map", postfix=".txt"
            )
            dca_utilities.write_contact_map(path, cats, metadata=metadata)
        else:
            if not output_dir:
                output_dir = "TPR_" + base
            dca_utilities.create_directories(output_dir)
            fig_path = (
                os.path.join(output_dir, f"TPR_{base}.png") if no_show else None
            )
            rates = viz.plot_true_positive_rates(
                show=not no_show, save_path=fig_path
            )
            path = dca_utilities.get_dca_output_file_path(
                output_dir, pdb_file, prefix="TPR_", postfix=".txt"
            )
            tpr_metadata = [
                "\n# First column is DCA true positive rate per rank"
                "\n# Second column is the PDB true positive rate per rank"
            ]
            dca_utilities.write_tp_rate(
                path,
                true_positive_rates_dict=rates,
                metadata=metadata[:6] + tpr_metadata,
            )

    elif the_command == "pdb_content":
        from ..eval.pdb import PDBContent

        content = PDBContent(pdb_file)
        print(f"PDB file: {content.pdb_file}")
        for chain_id, (biomol, seq) in content.pdb_chain_sequences.items():
            print(f"chain {chain_id} [{biomol}] ({len(seq)} residues): {seq}")

    elif the_command in ("trim_by_refseq", "trim_by_gap_size"):
        if the_command == "trim_by_refseq":
            trimmer = MSATrimmer(
                msa_file,
                biomolecule=biomolecule,
                refseq_file=refseq_file,
                max_gap=max_gap,
                device=device,
            )
            columns_to_remove = trimmer.trim_by_refseq(
                remove_all_gaps=remove_all_gaps
            )
        else:
            trimmer = MSATrimmer(msa_file, max_gap=max_gap)
            columns_to_remove = trimmer.trim_by_gap_size()
        if not output_dir:
            base = os.path.splitext(os.path.basename(msa_file))[0]
            output_dir = "Trimmed_" + base
        dca_utilities.create_directories(output_dir)
        path = dca_utilities.get_dca_output_file_path(
            output_dir, msa_file, prefix="Trimmed_", postfix=".fa"
        )
        dca_utilities.write_trimmed_msa(
            path,
            trimmer.alignment_ids,
            trimmer.alignment_sequences,
            columns_to_remove,
        )
    else:
        raise SystemExit(f"unknown command {the_command}")


def run_pydca(argv=None):
    args = build_parser().parse_args(argv)
    execute_from_command_line(**vars(args))


if __name__ == "__main__":
    run_pydca()
