"""``mfdca`` entry point of the port — mean-field DCA.

Port of ``pydca_tpu/cli/mfdca_main.py`` (which mirrors the reference CLI,
``pydca/mfdca_main.py``): same subcommands, flags and output naming
``MFDCA_{apc,raw}_fn_scores_<msa>.txt``, plus ``--device {cuda,cpu}``.
Ported so far: ``compute_fn`` with and without ``--apc`` on one device.
Every other subcommand and flag value is accepted by the parser and
rejected with ``NotImplementedError`` naming its ROADMAP item.

Run as ``python -m pydca_tpu_torch.cli.mfdca_main compute_fn protein
<msa> --apc --device cuda``.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from ..config_log import configure_logging
from ..io import output as dca_utilities
from ..meanfield import MeanFieldDCA

logger = logging.getLogger(__name__)

# subcommand -> the ROADMAP Queue 1 item that ports it
_UNPORTED_COMMANDS = {
    "compute_di": "Queue 1 #8 (DI scoring)",
    "compute_params": "Queue 1 #9 (mfdca compute_params)",
    "compute_fi": "Queue 1 #9 (mfdca compute_fi)",
    "compute_fij": "Queue 1 #9 (mfdca compute_fij)",
    "compute_fields": "Queue 1 #9 (mfdca compute_fields)",
    "compute_weights": "Queue 1 #9 (mfdca compute_weights)",
    "warmup": "Queue 1 #14 (cold start / warmup)",
    "compute_fn_batch": "Queue 1 #11 (family batches)",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="mfdca",
        description="Mean-field direct coupling analysis (pydca_tpu_torch, PyTorch/CUDA)",
    )
    subparsers = parser.add_subparsers(dest="the_command", required=True)
    for name, desc in [
        ("compute_di", "compute direct-information DCA scores (not ported)"),
        ("compute_fn", "compute Frobenius-norm DCA scores"),
        ("compute_params", "extract fields and ranked couplings (not ported)"),
        ("compute_fi", "compute (regularized) single-site frequencies (not ported)"),
        ("compute_fij", "compute (regularized) pair-site frequencies (not ported)"),
        ("compute_fields", "compute local fields (not ported)"),
        ("compute_weights", "compute per-sequence reweighting factors (not ported)"),
    ]:
        sp = subparsers.add_parser(name, help=desc)
        sp.add_argument("biomolecule", choices=["protein", "PROTEIN", "rna", "RNA"])
        sp.add_argument("msa_file")
        sp.add_argument("--seqid", type=float, help="sequence identity threshold")
        sp.add_argument("--pseudocount", type=float, help="relative pseudocount")
        sp.add_argument("--refseq_file", help="not ported (backmapping)")
        sp.add_argument("--output_dir", help="output directory")
        sp.add_argument("--verbose", action="store_true")
        sp.add_argument("--apc", action="store_true", help="average product correction")
        sp.add_argument(
            "--mesh", choices=["auto", "single"], default="auto",
            help="auto (default) / single; more than one device is not ported",
        )
        sp.add_argument(
            "--device", choices=["cuda", "cpu"], default="cuda",
            help="device to run on (default cuda; no fallback to cpu)",
        )
        if name == "compute_params":
            sp.add_argument(
                "--ranked_by",
                choices=["FN", "FN_APC", "DI", "DI_APC", "fn", "fn_apc", "di", "di_apc"],
            )
            sp.add_argument("--linear_dist", type=int)
            sp.add_argument("--num_site_pairs", type=int)

    sw = subparsers.add_parser("warmup", help="not ported")
    sw.add_argument("biomolecule", choices=["protein", "PROTEIN", "rna", "RNA"])
    sw.add_argument("msa_file")
    sw.add_argument("--seqid", type=float)
    sw.add_argument("--pseudocount", type=float)
    sw.add_argument("--mesh", choices=["auto", "single"], default="auto")
    sw.add_argument("--verbose", action="store_true")

    sb = subparsers.add_parser("compute_fn_batch", help="not ported")
    sb.add_argument("biomolecule", choices=["protein", "PROTEIN", "rna", "RNA"])
    sb.add_argument("msa_files", nargs="+")
    sb.add_argument("--seqid", type=float)
    sb.add_argument("--pseudocount", type=float)
    sb.add_argument("--output_dir")
    sb.add_argument("--verbose", action="store_true")
    sb.add_argument("--apc", action="store_true")
    return parser


def _reject_command(the_command) -> None:
    if the_command in _UNPORTED_COMMANDS:
        raise NotImplementedError(
            f"{the_command} is not ported yet (ROADMAP {_UNPORTED_COMMANDS[the_command]})"
        )


def _reject_unported(the_command, refseq_file, mesh, device) -> None:
    """Raise ``NotImplementedError`` for every request the port cannot
    honour yet; nothing is silently ignored."""
    _reject_command(the_command)
    if refseq_file:
        raise NotImplementedError(
            "--refseq_file is not ported yet (ROADMAP Queue 1 #12, backmapping)"
        )
    if (
        mesh == "auto"
        and torch.device(device).type == "cuda"
        and torch.cuda.device_count() > 1
    ):
        raise NotImplementedError(
            "--mesh over more than one device is not ported yet "
            "(ROADMAP Queue 1 #13); pass --mesh single"
        )


def execute_from_command_line(
    msa_file=None,
    biomolecule=None,
    seqid=None,
    pseudocount=None,
    the_command=None,
    refseq_file=None,
    verbose=False,
    output_dir=None,
    apc=False,
    mesh="auto",
    device="cuda",
):
    """Run one subcommand; returns the engine (its timers and caches)."""
    _reject_unported(the_command, refseq_file, mesh, device)
    if verbose:
        configure_logging()
    kwargs = {}
    if pseudocount is not None:
        kwargs["pseudocount"] = pseudocount
    if seqid is not None:
        kwargs["seqid"] = seqid
    inst = MeanFieldDCA(msa_file, biomolecule, device=device, **kwargs)

    if not output_dir:
        base, _ = os.path.splitext(os.path.basename(msa_file))
        output_dir = "MFDCA_output_" + base
    dca_utilities.create_directories(output_dir)

    if apc:
        score_type = "MFDCA Frobenius norm, average product corrected (APC)"
        sorted_fn = inst.compute_sorted_FN_APC()
        prefix = "MFDCA_apc_fn_scores_"
    else:
        score_type = "MFDCA raw Frobenius norm"
        sorted_fn = inst.compute_sorted_FN()
        prefix = "MFDCA_raw_fn_scores_"
    path = dca_utilities.get_dca_output_file_path(
        output_dir, msa_file, prefix=prefix, postfix=".txt"
    )
    # the header holds Meff, which the pipeline has computed by now
    dca_utilities.write_sorted_dca_scores(
        path, sorted_fn, metadata=dca_utilities.mfdca_param_metadata(inst),
        score_type=score_type,
    )
    logger.info("mfDCA stage timings:\n%s", inst.timers.summary())
    return inst


def run_meanfield_dca(argv=None):
    args = build_parser().parse_args(argv)
    _reject_command(args.the_command)
    return execute_from_command_line(
        msa_file=args.msa_file,
        biomolecule=args.biomolecule,
        seqid=args.seqid,
        pseudocount=args.pseudocount,
        the_command=args.the_command,
        refseq_file=args.refseq_file,
        verbose=args.verbose,
        output_dir=args.output_dir,
        apc=args.apc,
        mesh=args.mesh,
        device=args.device,
    )


if __name__ == "__main__":
    run_meanfield_dca()
