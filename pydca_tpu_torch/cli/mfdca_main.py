"""``mfdca`` entry point of the port — mean-field DCA.

Port of ``pydca_tpu/cli/mfdca_main.py`` (which mirrors the reference CLI,
``pydca/mfdca_main.py``): same subcommands, flags and output files, plus
``--device`` (``cuda``, ``cuda:K`` or ``cpu``).  Ported: ``compute_fn``,
``compute_di`` (each with and without ``--apc``), ``compute_fields``,
``compute_params``, ``compute_fi``, ``compute_fij`` and
``compute_weights``, on one device or, with ``--mesh auto`` (the
default), over one rank per card with the sequences sharded
(:mod:`pydca_tpu_torch.parallel`; rank 0 writes the files): under
``torchrun``, or from one process that sees several cards and is given
``--device cuda``, which starts the ranks itself
(:mod:`pydca_tpu_torch.parallel.spawn`); ``compute_fn_batch`` over many
families on one device (:mod:`pydca_tpu_torch.family`), with
``--refseq_file`` (scores and parameters mapped onto a reference
sequence, its template search on the same device); and ``warmup``, which
builds the kernels a run at the MSA's shapes loads
(:mod:`pydca_tpu_torch.warmup`) into the cache of
:func:`pydca_tpu_torch.runtime.enable_compilation_cache`.

Run as ``python -m pydca_tpu_torch.cli.mfdca_main compute_di protein
<msa> --apc --device cuda`` (or the console script ``mfdca-torch``), or
over K cards as ``torchrun
--nproc_per_node=K -m pydca_tpu_torch.cli.mfdca_main compute_fn protein
<msa> --apc``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from ..backmap import SequenceBackmapper
from ..config_log import configure_logging
from ..family import BatchRun, FamilyBatch, family_meanfield_scores
from ..io import output as dca_utilities
from ..io.fasta import read_msa
from ..meanfield import MeanFieldDCA
from ..parallel.fit import launch_mesh
from ..parallel.spawn import spawn_cli, spawn_world
from ..profiling import StageTimers
from ..runtime import enable_compilation_cache

logger = logging.getLogger(__name__)


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
            help="auto (default): shard the sequences over the ranks, one process "
            "per card: under torchrun --nproc_per_node=K, or started here with "
            "--device cuda when K > 1 cards are visible; single: one device",
        )
        sp.add_argument(
            "--device", default="cuda",
            help="cuda (under torchrun: cuda:LOCAL_RANK), cuda:K or cpu "
            "(default cuda; no fallback to cpu)",
        )
        if name == "compute_params":
            sp.add_argument(
                "--ranked_by",
                choices=["FN", "FN_APC", "DI", "DI_APC", "fn", "fn_apc", "di", "di_apc"],
            )
            sp.add_argument("--linear_dist", type=int)
            sp.add_argument("--num_site_pairs", type=int)

    sw = subparsers.add_parser(
        "warmup",
        help="build the CUDA kernels an mfdca run at this MSA's shapes loads into "
        "the build cache (no compute); the next mfdca process starts built",
    )
    sw.add_argument("biomolecule", choices=["protein", "PROTEIN", "rna", "RNA"])
    sw.add_argument("msa_file")
    sw.add_argument("--seqid", type=float)
    sw.add_argument("--pseudocount", type=float)
    sw.add_argument("--mesh", choices=["auto", "single"], default="auto")
    sw.add_argument("--device", default="cuda",
                    help="cuda, cuda:K or cpu (the CPU builds nothing)")
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


def _writer(write: bool):
    """``emit(fn, *args, **kw)``: calls the writer ``fn`` when ``write``."""
    def emit(fn, *args, **kw):
        if write:
            fn(*args, **kw)
    return emit


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
    if verbose:
        configure_logging()
    mesh, device = launch_mesh(mesh, device)
    kwargs = {}
    if pseudocount is not None:
        kwargs["pseudocount"] = pseudocount
    if seqid is not None:
        kwargs["seqid"] = seqid
    inst = MeanFieldDCA(msa_file, biomolecule, device=device, mesh=mesh, **kwargs)
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
    writer = mesh is None or mesh.rank == 0  # under a mesh, rank 0 writes
    if writer:
        dca_utilities.create_directories(output_dir)
    write_outputs(inst, the_command, msa_file, output_dir, apc=apc,
                  ranked_by=ranked_by, linear_dist=linear_dist,
                  num_site_pairs=num_site_pairs, seqbackmapper=seqbackmapper,
                  write=writer)
    logger.info("mfDCA stage timings:\n%s", inst.timers.summary())
    return inst


def write_outputs(inst, the_command, msa_file, output_dir, *, apc=False,
                  ranked_by=None, linear_dist=None, num_site_pairs=None,
                  seqbackmapper=None, write=True):
    """Compute what ``the_command`` asks of the engine ``inst`` and write its
    files into ``output_dir`` (``pydca_tpu/cli/mfdca_main.py:154-277``).
    Each header is built after the compute: it holds Meff, the weights'
    sum, which the compute has made by then.  ``write=False`` computes the
    same and writes nothing (a rank other than 0 of a mesh)."""
    emit = _writer(write)

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
        emit(dca_utilities.write_sorted_dca_scores,
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
        emit(dca_utilities.write_sorted_dca_scores,
            path, sorted_fn, metadata=param_metadata(), score_type=score_type
        )

    if the_command == "compute_fields":
        fields = inst.compute_fields()
        metadata = param_metadata() + dca_utilities.residue_repr_metadata(
            inst.biomolecule
        )
        emit(dca_utilities.write_fields_csv,
            path_of("fields_"), sorted(fields.items()), metadata=metadata
        )

    if the_command == "compute_params":
        fields, couplings = inst.compute_params(
            seqbackmapper=seqbackmapper,
            ranked_by=ranked_by,
            linear_dist=linear_dist,
            num_site_pairs=num_site_pairs,
        )
        emit(dca_utilities.write_params,
            path_of("fields_"), path_of("couplings_"), fields, couplings,
            param_metadata(), ranked_by=ranked_by, linear_dist=linear_dist,
        )

    if the_command == "compute_weights":
        weights = inst.get_sequences_weight().cpu().numpy()
        emit(dca_utilities.write_sequence_weights,
            path_of("weights_"), weights, ids=inst.msa.ids, metadata=param_metadata()
        )

    if the_command == "compute_fi":
        fi = inst.get_reg_single_site_freqs().cpu().numpy()
        metadata = param_metadata() + dca_utilities.residue_repr_metadata(
            inst.biomolecule
        )
        emit(dca_utilities.write_single_site_freqs,
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
        emit(dca_utilities.write_pair_site_freqs,
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


def run_warmup(args) -> float:
    """``mfdca warmup``: read the MSA (its post-dedup N, L, q) and build
    what a run at those shapes loads; prints the JAX CLI's line."""
    from ..warmup import warmup_meanfield

    if args.verbose:
        configure_logging()
    msa = read_msa(args.msa_file, args.biomolecule)
    dt = warmup_meanfield(
        msa.num_seqs, msa.seqs_len, msa.q,
        seqid=0.8 if args.seqid is None else args.seqid,
        pseudocount=0.5 if args.pseudocount is None else args.pseudocount,
        mesh=None if args.mesh == "single" else args.mesh,
        device=args.device,
    )
    print(f"warmed mfDCA cache for N={msa.num_seqs}, L={msa.seqs_len}, "
          f"q={msa.q} ({dt:.1f} s build)")
    return dt


def run_meanfield_dca(argv=None):
    """The ``mfdca`` CLI on ``argv`` (default ``sys.argv[1:]``); returns
    the engine, or ``None`` when it started one rank a card (and raises
    ``SystemExit`` with a failed rank's exit code)."""
    enable_compilation_cache()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.the_command == "warmup":
        return run_warmup(args)
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
    world = spawn_world(args.mesh, args.device)
    if world:
        code = spawn_cli(run_meanfield_dca, argv, world, args.device)
        if code:
            raise SystemExit(code)
        return None
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


def main(argv=None) -> None:
    """The ``mfdca-torch`` console script: :func:`run_meanfield_dca` without its
    result, so that a finished run exits 0 (a failed rank raises
    ``SystemExit`` with its code)."""
    run_meanfield_dca(argv)


if __name__ == "__main__":
    main()
