"""``mfdca`` entry point of the port — mean-field DCA.

Port of ``pydca_tpu/cli/mfdca_main.py`` (which mirrors the reference CLI,
``pydca/mfdca_main.py``): same subcommands, flags and output files, plus
``--device {cuda,cpu}``.  Ported: ``compute_fn``, ``compute_di`` (each
with and without ``--apc``), ``compute_fields``, ``compute_params``,
``compute_fi``, ``compute_fij`` and ``compute_weights`` on one device, and
``compute_fn_batch`` over many families (:mod:`pydca_tpu_torch.family`),
with ``--refseq_file`` (scores and parameters mapped onto a reference
sequence, its template search on the same device).  ``warmup`` and a mesh
over more than one card are accepted by the parser and rejected with
``NotImplementedError`` naming their ROADMAP item.

Run as ``python -m pydca_tpu_torch.cli.mfdca_main compute_di protein
<msa> --apc --device cuda``.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from ..backmap import SequenceBackmapper
from ..config_log import configure_logging
from ..family import BatchRun, FamilyBatch, family_meanfield_scores
from ..io import output as dca_utilities
from ..io.fasta import read_msa
from ..meanfield import MeanFieldDCA
from ..profiling import StageTimers

logger = logging.getLogger(__name__)

# subcommand -> the ROADMAP Queue 1 item that ports it
_UNPORTED_COMMANDS = {
    "warmup": "Queue 1 #14 (cold start / warmup)",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="mfdca",
        description="Mean-field direct coupling analysis (pydca_tpu_torch, PyTorch/CUDA)",
    )
    subparsers = parser.add_subparsers(dest="the_command", required=True)
    for name, desc in [
        ("compute_di", "compute direct-information DCA scores"),
        ("compute_fn", "compute Frobenius-norm DCA scores"),
        ("compute_params", "extract fields and ranked couplings"),
        ("compute_fi", "compute (regularized) single-site frequencies"),
        ("compute_fij", "compute (regularized) pair-site frequencies"),
        ("compute_fields", "compute local fields"),
        ("compute_weights", "compute per-sequence reweighting factors"),
    ]:
        sp = subparsers.add_parser(name, help=desc)
        sp.add_argument("biomolecule", choices=["protein", "PROTEIN", "rna", "RNA"])
        sp.add_argument("msa_file")
        sp.add_argument("--seqid", type=float, help="sequence identity threshold")
        sp.add_argument("--pseudocount", type=float, help="relative pseudocount")
        sp.add_argument("--refseq_file", help="FASTA file with reference sequence")
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

    sb = subparsers.add_parser(
        "compute_fn_batch", help="FN scores for many MSA families, one after another",
    )
    sb.add_argument("biomolecule", choices=["protein", "PROTEIN", "rna", "RNA"])
    sb.add_argument("msa_files", nargs="+", help="one FASTA file per family")
    sb.add_argument("--seqid", type=float)
    sb.add_argument("--pseudocount", type=float)
    sb.add_argument("--output_dir")
    sb.add_argument("--verbose", action="store_true")
    sb.add_argument("--apc", action="store_true")
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


def _reject_unported(the_command, mesh, device) -> None:
    """Raise ``NotImplementedError`` for every request the port cannot
    honour yet; nothing is silently ignored."""
    _reject_command(the_command)
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
    ranked_by=None,
    linear_dist=None,
    num_site_pairs=None,
    mesh="auto",
    device="cuda",
):
    """Run one subcommand; returns the engine (its timers and caches)."""
    _reject_unported(the_command, mesh, device)
    if verbose:
        configure_logging()
    kwargs = {}
    if pseudocount is not None:
        kwargs["pseudocount"] = pseudocount
    if seqid is not None:
        kwargs["seqid"] = seqid
    inst = MeanFieldDCA(msa_file, biomolecule, device=device, **kwargs)
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
        output_dir = "MFDCA_output_" + base
    dca_utilities.create_directories(output_dir)
    write_outputs(inst, the_command, msa_file, output_dir, apc=apc,
                  ranked_by=ranked_by, linear_dist=linear_dist,
                  num_site_pairs=num_site_pairs, seqbackmapper=seqbackmapper)
    logger.info("mfDCA stage timings:\n%s", inst.timers.summary())
    return inst


def write_outputs(inst, the_command, msa_file, output_dir, *, apc=False,
                  ranked_by=None, linear_dist=None, num_site_pairs=None,
                  seqbackmapper=None):
    """Compute what ``the_command`` asks of the engine ``inst`` and write its
    files into ``output_dir`` (``pydca_tpu/cli/mfdca_main.py:154-277``).
    Each header is built after the compute: it holds Meff, the weights'
    sum, which the compute has made by then."""
    def param_metadata():
        return dca_utilities.mfdca_param_metadata(inst)

    def path_of(prefix):
        return dca_utilities.get_dca_output_file_path(
            output_dir, msa_file, prefix=prefix, postfix=".txt"
        )

    if the_command == "compute_di":
        if apc:
            sorted_di = inst.compute_sorted_DI_APC(seqbackmapper=seqbackmapper)
            score_type = " MF DI average product corrected (APC)"
            path = path_of("MFDCA_apc_di_scores_")
        else:
            sorted_di = inst.compute_sorted_DI(seqbackmapper=seqbackmapper)
            score_type = "raw DI"
            path = path_of("MFDCA_raw_di_scores_")
        dca_utilities.write_sorted_dca_scores(
            path, sorted_di, metadata=param_metadata(), score_type=score_type
        )

    if the_command == "compute_fn":
        if apc:
            score_type = "MFDCA Frobenius norm, average product corrected (APC)"
            sorted_fn = inst.compute_sorted_FN_APC(seqbackmapper=seqbackmapper)
            path = path_of("MFDCA_apc_fn_scores_")
        else:
            score_type = "MFDCA raw Frobenius norm"
            sorted_fn = inst.compute_sorted_FN(seqbackmapper=seqbackmapper)
            path = path_of("MFDCA_raw_fn_scores_")
        dca_utilities.write_sorted_dca_scores(
            path, sorted_fn, metadata=param_metadata(), score_type=score_type
        )

    if the_command == "compute_fields":
        fields = inst.compute_fields()
        metadata = param_metadata() + dca_utilities.residue_repr_metadata(
            inst.biomolecule
        )
        dca_utilities.write_fields_csv(
            path_of("fields_"), sorted(fields.items()), metadata=metadata
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
            param_metadata(), ranked_by=ranked_by, linear_dist=linear_dist,
        )

    if the_command == "compute_weights":
        weights = inst.get_sequences_weight().cpu().numpy()
        dca_utilities.write_sequence_weights(
            path_of("weights_"), weights, ids=inst.msa.ids, metadata=param_metadata()
        )

    if the_command == "compute_fi":
        fi = inst.get_reg_single_site_freqs().cpu().numpy()
        metadata = param_metadata() + dca_utilities.residue_repr_metadata(
            inst.biomolecule
        )
        dca_utilities.write_single_site_freqs(
            path_of("fi_"),
            fi,
            seqs_len=inst.sequences_len,
            num_site_states=inst.num_site_states,
            metadata=metadata,
        )

    if the_command == "compute_fij":
        fij = inst.get_reg_pair_site_freqs().cpu().numpy()
        metadata = param_metadata() + dca_utilities.residue_repr_metadata(
            inst.biomolecule
        )
        dca_utilities.write_pair_site_freqs(
            path_of("fij_"),
            fij,
            seqs_len=inst.sequences_len,
            num_site_states=inst.num_site_states,
            metadata=metadata,
        )


def execute_batch(
    msa_files,
    biomolecule,
    seqid=None,
    pseudocount=None,
    output_dir=None,
    apc=False,
    verbose=False,
    device="cuda",
):
    """N families -> per-family mean-field scores -> per-family files
    (``pydca_tpu/cli/mfdca_main.py:280-332``).  Returns a
    :class:`~pydca_tpu_torch.family.BatchRun` (no fits)."""
    if verbose:
        configure_logging()
    timers = StageTimers()
    with timers.stage("read"):
        msas = [read_msa(f, biomolecule) for f in msa_files]
    with timers.stage("compute"):
        scores_per_family = family_meanfield_scores(
            FamilyBatch(msas),
            seqid=0.8 if seqid is None else float(seqid),
            pseudocount=0.5 if pseudocount is None else float(pseudocount),
            apc=apc,
            device=device,
        )
    if not output_dir:
        output_dir = "MFDCA_batch_output"
    dca_utilities.create_directories(output_dir)
    if apc:
        prefix = "MFDCA_apc_fn_scores_"
        score_type = "MFDCA Frobenius norm, average product corrected (APC)"
    else:
        prefix = "MFDCA_raw_fn_scores_"
        score_type = "MFDCA raw Frobenius norm"
    with timers.stage("write"):
        paths = dca_utilities.write_batch_scores(
            output_dir, msa_files, msas, scores_per_family, prefix, score_type
        )
    logger.info("mfDCA family batch of %d MSAs:\n%s", len(msas), timers.summary())
    return BatchRun(paths, [], timers)


def run_meanfield_dca(argv=None):
    args = build_parser().parse_args(argv)
    _reject_command(args.the_command)
    if args.the_command == "compute_fn_batch":
        return execute_batch(
            msa_files=args.msa_files,
            biomolecule=args.biomolecule,
            seqid=args.seqid,
            pseudocount=args.pseudocount,
            output_dir=args.output_dir,
            apc=args.apc,
            verbose=args.verbose,
            device=args.device,
        )
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
        ranked_by=getattr(args, "ranked_by", None),
        linear_dist=getattr(args, "linear_dist", None),
        num_site_pairs=getattr(args, "num_site_pairs", None),
        mesh=args.mesh,
        device=args.device,
    )


if __name__ == "__main__":
    run_meanfield_dca()
