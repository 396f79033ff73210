"""``plmdca`` entry point of the port — pseudolikelihood-maximization DCA.

Port of ``pydca_tpu/cli/plmdca_main.py`` (which mirrors the reference CLI,
``pydca/plmdca_main.py``): same subcommands, flags and output naming
``PLMDCA_{apc,raw}_fn_scores_<msa>.txt``, plus ``--device {cuda,cpu}``.
Ported so far: ``compute_fn`` with and without ``--apc`` on one device.
Every other subcommand and flag value is accepted by the parser and
rejected with ``NotImplementedError`` naming its ROADMAP item.

Run as ``python -m pydca_tpu_torch.cli.plmdca_main compute_fn protein
<msa> --apc --device cuda``.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..config_log import configure_logging
from ..io import output as dca_utilities
from ..plm import PlmDCA

# subcommand -> the ROADMAP Queue 1 item that ports it
_UNPORTED_COMMANDS = {
    "compute_di": "Queue 1 #8 (DI scoring)",
    "compute_params": "Queue 1 #7 (compute_params)",
    "warmup": "Queue 1 #14 (cold start / warmup)",
    "compute_fn_batch": "Queue 1 #11 (family batches)",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="plmdca",
        description=(
            "Pseudolikelihood-maximization direct coupling analysis "
            "(pydca_tpu_torch, PyTorch/CUDA)"
        ),
    )
    subparsers = parser.add_subparsers(dest="the_command", required=True)
    for name, desc in [
        ("compute_fn", "compute Frobenius-norm DCA scores"),
        ("compute_di", "compute direct-information DCA scores (not ported)"),
        ("compute_params", "extract fields and ranked couplings (not ported)"),
    ]:
        sp = subparsers.add_parser(name, help=desc)
        sp.add_argument("biomolecule", choices=["protein", "PROTEIN", "rna", "RNA"])
        sp.add_argument("msa_file")
        sp.add_argument("--seqid", type=float)
        sp.add_argument("--lambda_h", type=float)
        sp.add_argument("--lambda_J", type=float)
        sp.add_argument("--max_iterations", type=int)
        sp.add_argument("--num_threads", type=int, help="ignored")
        sp.add_argument(
            "--device", choices=["cuda", "cpu"], default="cuda",
            help="device to run on (default cuda; no fallback to cpu)",
        )
        sp.add_argument("--seq_block", type=int, help="not ported (streaming)")
        sp.add_argument(
            "--precision", choices=["auto", "bfloat16", "float32"],
            help="matmul operand precision; only float32 (= auto) is ported",
        )
        sp.add_argument(
            "--param_space", choices=["auto", "w2", "compact"],
            help="optimizer parameterization; only compact (= auto) is ported",
        )
        sp.add_argument("--checkpoint", metavar="PATH", help="not ported")
        sp.add_argument(
            "--mesh", choices=["auto", "single"], default="auto",
            help="auto (default) / single; more than one device is not ported",
        )
        sp.add_argument("--refseq_file", help="not ported (backmapping)")
        sp.add_argument("--output_dir")
        sp.add_argument("--verbose", action="store_true")
        sp.add_argument("--apc", action="store_true")
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
    sb = subparsers.add_parser("compute_fn_batch", help="not ported")
    sb.add_argument("biomolecule", choices=["protein", "PROTEIN", "rna", "RNA"])
    sb.add_argument("msa_files", nargs="+")
    return parser


def _reject_command(the_command) -> None:
    if the_command in _UNPORTED_COMMANDS:
        raise NotImplementedError(
            f"{the_command} is not ported yet (ROADMAP {_UNPORTED_COMMANDS[the_command]})"
        )


def _reject_unported(the_command, refseq_file, checkpoint, seq_block,
                     precision, param_space, mesh, device) -> None:
    """Raise ``NotImplementedError`` for every request the port cannot
    honour yet; nothing is silently ignored."""
    _reject_command(the_command)
    if refseq_file:
        raise NotImplementedError(
            "--refseq_file is not ported yet (ROADMAP Queue 1 #12, backmapping)"
        )
    if checkpoint:
        raise NotImplementedError(
            "--checkpoint (and the retry loop) is not ported yet "
            "(ROADMAP Queue 1 #6)"
        )
    if seq_block is not None:
        raise NotImplementedError(
            "--seq_block (streaming) is not ported yet (ROADMAP Queue 1 #10)"
        )
    if precision in ("bfloat16", "bf16"):
        raise NotImplementedError(
            "--precision bfloat16 is not ported yet (ROADMAP Queue 1 #6)"
        )
    if param_space == "w2":
        raise NotImplementedError(
            "--param_space w2 is not ported yet (ROADMAP Queue 1 #10)"
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
    the_command=None,
    seqid=None,
    lambda_h=None,
    lambda_J=None,
    max_iterations=None,
    num_threads=None,
    refseq_file=None,
    verbose=False,
    output_dir=None,
    apc=False,
    seq_block=None,
    precision=None,
    checkpoint=None,
    mesh="auto",
    param_space="auto",
    device="cuda",
):
    """Run one subcommand; returns the engine (its timers and fit result)."""
    _reject_unported(the_command, refseq_file, checkpoint, seq_block,
                     precision, param_space, mesh, device)
    if verbose:
        configure_logging()
    inst = PlmDCA(
        msa_file,
        biomolecule,
        seqid=seqid,
        lambda_h=lambda_h,
        lambda_J=lambda_J,
        max_iterations=max_iterations,
        num_threads=num_threads,
        verbose=verbose,
        device=device,
    )
    param_metadata = dca_utilities.plmdca_param_metadata(inst)
    if not output_dir:
        base, _ = os.path.splitext(os.path.basename(msa_file))
        output_dir = "PLMDCA_output_" + base
    dca_utilities.create_directories(output_dir)

    if apc:
        score_type = "PLMDCA Frobenius norm, average product corrected (APC)"
        scores = inst.compute_sorted_FN_APC()
        prefix = "PLMDCA_apc_fn_scores_"
    else:
        score_type = "PLMDCA Frobenius norm, non-APC (not average product corrected)"
        scores = inst.compute_sorted_FN()
        prefix = "PLMDCA_raw_fn_scores_"
    path = dca_utilities.get_dca_output_file_path(
        output_dir, msa_file, prefix=prefix, postfix=".txt"
    )
    dca_utilities.write_sorted_dca_scores(
        path, scores, metadata=param_metadata, score_type=score_type
    )
    return inst


def run_plm_dca(argv=None):
    args = build_parser().parse_args(argv)
    _reject_command(args.the_command)
    return execute_from_command_line(
        msa_file=args.msa_file,
        biomolecule=args.biomolecule,
        the_command=args.the_command,
        seqid=args.seqid,
        lambda_h=args.lambda_h,
        lambda_J=args.lambda_J,
        max_iterations=args.max_iterations,
        num_threads=args.num_threads,
        refseq_file=args.refseq_file,
        seq_block=args.seq_block,
        precision=args.precision,
        checkpoint=args.checkpoint,
        mesh=args.mesh,
        param_space=args.param_space or "auto",
        verbose=args.verbose,
        output_dir=args.output_dir,
        apc=args.apc,
        device=args.device,
    )


if __name__ == "__main__":
    run_plm_dca()
