"""``plmdca`` entry point of the port — pseudolikelihood-maximization DCA.

Port of ``pydca_tpu/cli/plmdca_main.py`` (which mirrors the reference CLI,
``pydca/plmdca_main.py``): same subcommands, flags and output files, plus
``--device {cuda,cpu}``.  Ported: ``compute_fn`` and ``compute_di`` (each
with and without ``--apc``) and ``compute_params`` on one device, with
``--refseq_file`` (scores and parameters mapped onto a reference sequence,
its template search on the same device), ``--seq_block`` (the streamed
loss; past 1 GiB of logits the engine streams by itself) and
``--checkpoint`` (resume and bounded retry), and
``compute_fn_batch`` over many families (:mod:`pydca_tpu_torch.family`).
``warmup`` and the flag values the port cannot honour yet are accepted by
the parser and rejected with ``NotImplementedError`` naming their ROADMAP
item.

Run as ``python -m pydca_tpu_torch.cli.plmdca_main compute_di protein
<msa> --apc --device cuda``.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from ..backmap import SequenceBackmapper
from ..config_log import configure_logging
from ..family import BatchRun, FamilyFit, family_plm_fit_bucketed
from ..io import output as dca_utilities
from ..io.fasta import read_msa
from ..plm import PlmDCA
from ..profiling import StageTimers

logger = logging.getLogger(__name__)

# subcommand -> the ROADMAP Queue 1 item that ports it
_UNPORTED_COMMANDS = {
    "warmup": "Queue 1 #14 (cold start / warmup)",
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
        ("compute_di", "compute direct-information DCA scores"),
        ("compute_params", "extract fields and ranked couplings"),
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
        sp.add_argument(
            "--seq_block", type=int,
            help="stream the loss over sequence blocks of this size "
            "(auto-enabled for very deep alignments)",
        )
        sp.add_argument(
            "--precision", choices=["auto", "bfloat16", "float32"],
            help="matmul operand precision; only float32 (= auto) is ported",
        )
        sp.add_argument(
            "--param_space", choices=["auto", "w2", "compact"],
            help="optimizer parameterization; only compact (= auto) is ported",
        )
        sp.add_argument(
            "--checkpoint", metavar="PATH",
            help="periodically save the optimizer state to PATH and resume "
            "from it if it exists",
        )
        sp.add_argument(
            "--mesh", choices=["auto", "single"], default="auto",
            help="auto (default) / single; more than one device is not ported",
        )
        sp.add_argument("--refseq_file", help="FASTA file with reference sequence")
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
    sb = subparsers.add_parser(
        "compute_fn_batch",
        help="FN scores for many MSA families, fitted one after another",
    )
    sb.add_argument("biomolecule", choices=["protein", "PROTEIN", "rna", "RNA"])
    sb.add_argument("msa_files", nargs="+", help="one FASTA file per family")
    sb.add_argument("--seqid", type=float)
    sb.add_argument("--max_iterations", type=int)
    sb.add_argument("--output_dir")
    sb.add_argument("--verbose", action="store_true")
    sb.add_argument("--apc", action="store_true")
    sb.add_argument(
        "--no_bucket", action="store_true",
        help="accepted for the JAX CLI's flags; changes nothing, since every "
        "family is fitted at its own size",
    )
    sb.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="device to run on (default cuda; no fallback to cpu)",
    )
    return parser


def _reject_command(the_command) -> None:
    if the_command in _UNPORTED_COMMANDS:
        raise NotImplementedError(
            f"{the_command} is not ported yet (ROADMAP {_UNPORTED_COMMANDS[the_command]})"
        )


def _reject_unported(the_command, precision, param_space, mesh, device) -> None:
    """Raise ``NotImplementedError`` for every request the port cannot
    honour yet; nothing is silently ignored."""
    _reject_command(the_command)
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
    ranked_by=None,
    linear_dist=None,
    num_site_pairs=None,
    seq_block=None,
    precision=None,
    checkpoint=None,
    mesh="auto",
    param_space="auto",
    device="cuda",
):
    """Run one subcommand; returns the engine (its timers and fit result)."""
    _reject_unported(the_command, precision, param_space, mesh, device)
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
        seq_block=seq_block,
        checkpoint_path=checkpoint,
    )
    seqbackmapper = None
    if refseq_file:
        seqbackmapper = SequenceBackmapper(
            alignment_data=list(inst.msa.data),
            refseq_file=refseq_file,
            biomolecule=inst.biomolecule,
            device=inst.device,
        )
    if not output_dir:
        base, _ = os.path.splitext(os.path.basename(msa_file))
        output_dir = "PLMDCA_output_" + base
    dca_utilities.create_directories(output_dir)
    write_outputs(inst, the_command, msa_file, output_dir, apc=apc,
                  ranked_by=ranked_by, linear_dist=linear_dist,
                  num_site_pairs=num_site_pairs, seqbackmapper=seqbackmapper)
    return inst


def write_outputs(inst, the_command, msa_file, output_dir, *, apc=False,
                  ranked_by=None, linear_dist=None, num_site_pairs=None,
                  seqbackmapper=None):
    """Compute what ``the_command`` asks of the engine ``inst`` and write its
    files into ``output_dir`` (``pydca_tpu/cli/plmdca_main.py:199-265``)."""
    param_metadata = dca_utilities.plmdca_param_metadata(inst)

    def path_of(prefix):
        return dca_utilities.get_dca_output_file_path(
            output_dir, msa_file, prefix=prefix, postfix=".txt"
        )

    if the_command == "compute_fn":
        if apc:
            score_type = "PLMDCA Frobenius norm, average product corrected (APC)"
            scores = inst.compute_sorted_FN_APC(seqbackmapper=seqbackmapper)
            path = path_of("PLMDCA_apc_fn_scores_")
        else:
            score_type = "PLMDCA Frobenius norm, non-APC (not average product corrected)"
            scores = inst.compute_sorted_FN(seqbackmapper=seqbackmapper)
            path = path_of("PLMDCA_raw_fn_scores_")
        dca_utilities.write_sorted_dca_scores(
            path, scores, metadata=param_metadata, score_type=score_type
        )

    if the_command == "compute_di":
        if apc:
            score_type = "PLMDCA  DI scores, average product corrected (APC)"
            scores = inst.compute_sorted_DI_APC(seqbackmapper=seqbackmapper)
            path = path_of("PLMDCA_apc_di_scores_")
        else:
            score_type = "PLMDCA DI scores, non-APC (not average product corrected)"
            scores = inst.compute_sorted_DI(seqbackmapper=seqbackmapper)
            path = path_of("PLMDCA_raw_di_scores_")
        dca_utilities.write_sorted_dca_scores(
            path, scores, metadata=param_metadata, score_type=score_type
        )

    if the_command == "compute_params":
        fields, couplings = inst.compute_params(
            seqbackmapper=seqbackmapper,
            ranked_by=ranked_by,
            linear_dist=linear_dist,
            num_site_pairs=num_site_pairs,
        )
        dca_utilities.write_params(
            path_of("fields_"), path_of("couplings_"), fields, couplings,
            param_metadata, ranked_by=ranked_by, linear_dist=linear_dist,
        )


def execute_batch(
    msa_files,
    biomolecule,
    seqid=None,
    max_iterations=None,
    output_dir=None,
    apc=False,
    verbose=False,
    bucket=True,
    device="cuda",
):
    """N families -> per-family fits -> per-family ranked score files
    (``pydca_tpu/cli/plmdca_main.py:268-344``) through
    ``family_plm_fit_bucketed``: each family is fitted at its own size and
    scored as soon as its fit ends.  ``bucket=False`` (``--no_bucket``)
    changes nothing, since the port never pads; it is accepted for the JAX
    CLI's flags and logged.  Returns a
    :class:`~pydca_tpu_torch.family.BatchRun`."""
    if verbose:
        configure_logging()
    timers = StageTimers()
    with timers.stage("read"):
        msas = [read_msa(f, biomolecule) for f in msa_files]
    seqid_v = 0.8 if seqid is None else float(seqid)
    iters = 100 if max_iterations is None else int(max_iterations)
    fits = [None] * len(msas)

    def record(f, st, seconds):
        fits[f] = FamilyFit(st.k, st.n_evals, st.host_syncs, seconds)
        logger.info("family %d (N=%d, L=%d): %d iterations, %d evaluations, %.3f s",
                    f, msas[f].num_seqs, msas[f].seqs_len, st.k, st.n_evals, seconds)

    if not bucket:
        logger.info("--no_bucket changes nothing here: every family is fitted unpadded")
    with timers.stage("compute"):
        scores_per_family, stats_d = family_plm_fit_bucketed(
            msas, seqid=seqid_v, max_iterations=iters, apc=apc, device=device,
            progress_fn=record,
        )
    # the padded-FLOP figures describe the JAX package's vmap, not this run
    logger.info("family batch: %d families, each fitted at its own size (%d iterations, "
                "%.3f s of fits); a padded vmap would do %.2fx the useful FLOPs in %d "
                "buckets, %.2fx in one block", len(msas), sum(f.num_iters for f in fits),
                sum(f.seconds for f in fits), stats_d["bucketed_waste"],
                stats_d["num_buckets"], stats_d["single_block_waste"])
    if not output_dir:
        output_dir = "PLMDCA_batch_output"
    dca_utilities.create_directories(output_dir)
    if apc:
        prefix = "PLMDCA_apc_fn_scores_"
        score_type = "PLMDCA Frobenius norm, average product corrected (APC)"
    else:
        prefix = "PLMDCA_raw_fn_scores_"
        score_type = "PLMDCA Frobenius norm, non-APC (not average product corrected)"
    with timers.stage("write"):
        paths = dca_utilities.write_batch_scores(
            output_dir, msa_files, msas, scores_per_family, prefix, score_type
        )
    return BatchRun(paths, fits, timers)


def run_plm_dca(argv=None):
    args = build_parser().parse_args(argv)
    _reject_command(args.the_command)
    if args.the_command == "compute_fn_batch":
        return execute_batch(
            msa_files=args.msa_files,
            biomolecule=args.biomolecule,
            seqid=args.seqid,
            max_iterations=args.max_iterations,
            output_dir=args.output_dir,
            apc=args.apc,
            verbose=args.verbose,
            bucket=not args.no_bucket,
            device=args.device,
        )
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
        ranked_by=getattr(args, "ranked_by", None),
        linear_dist=getattr(args, "linear_dist", None),
        num_site_pairs=getattr(args, "num_site_pairs", None),
        device=args.device,
    )


if __name__ == "__main__":
    run_plm_dca()
