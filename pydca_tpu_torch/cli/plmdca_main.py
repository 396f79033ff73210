"""``plmdca`` entry point of the port — pseudolikelihood-maximization DCA.

Port of ``pydca_tpu/cli/plmdca_main.py`` (which mirrors the reference CLI,
``pydca/plmdca_main.py``): same subcommands, flags and output files, plus
``--device`` (``cuda``, ``cuda:K`` or ``cpu``).  Ported: ``compute_fn``
and ``compute_di`` (each with and without ``--apc``) and
``compute_params``, on one device or, with ``--mesh auto`` (the default),
over one rank per card with the sequences sharded
(:mod:`pydca_tpu_torch.parallel`; rank 0 writes the files): under
``torchrun``, or from one process that sees several cards and is given
``--device cuda``, which starts the ranks itself
(:mod:`pydca_tpu_torch.parallel.spawn`).  With ``--refseq_file`` (scores
and parameters mapped onto a reference sequence, its template search on
the same device), ``--seq_block`` (the streamed loss; past 1 GiB of
logits a card the engine streams by itself), ``--checkpoint`` (resume and
bounded retry), ``--precision bfloat16`` (bfloat16 operands for the
logits products) and ``--param_space`` (taken for the JAX CLI's sake: every
value fits the compact layout); ``compute_fn_batch`` over many families on one device,
fitted in lock-step per (N, L) bucket or, with ``--no_bucket``, all at once
(:mod:`pydca_tpu_torch.family`); ``warmup``, which builds the kernels a
run at the MSA's shapes loads (:mod:`pydca_tpu_torch.warmup`).  The
kernels are cached where
:func:`pydca_tpu_torch.runtime.enable_compilation_cache` says
(``$PYDCA_TPU_CACHE_DIR``).

Run as ``python -m pydca_tpu_torch.cli.plmdca_main compute_di protein
<msa> --apc --device cuda`` (or the console script ``plmdca-torch``), or
over K cards as ``torchrun --nproc_per_node=K -m
pydca_tpu_torch.cli.plmdca_main compute_fn protein <msa> --apc``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from ..backmap import SequenceBackmapper
from ..config_log import configure_logging
from ..family import (
    BatchRun,
    FamilyBatch,
    FamilyFit,
    family_plm_fit,
    family_plm_fit_bucketed,
    family_plm_scores,
    padded_flop_stats,
)
from ..io import output as dca_utilities
from ..io.fasta import read_msa
from ..parallel.fit import launch_mesh
from ..parallel.spawn import spawn_cli, spawn_world
from ..plm import PlmDCA
from ..profiling import StageTimers
from ..runtime import enable_compilation_cache

logger = logging.getLogger(__name__)


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
            "--device", default="cuda",
            help="cuda (under torchrun: cuda:LOCAL_RANK), cuda:K or cpu "
            "(default cuda; no fallback to cpu)",
        )
        sp.add_argument(
            "--seq_block", type=int,
            help="stream the loss over sequence blocks of this size "
            "(auto-enabled for very deep alignments)",
        )
        sp.add_argument(
            "--precision", choices=["auto", "bfloat16", "float32"],
            help="operand precision of the two logits products (default auto = "
            "float32; bfloat16 rounds both products' operands to bfloat16 and "
            "accumulates in float32)",
        )
        sp.add_argument(
            "--param_space", choices=["auto", "w2", "compact"],
            help="taken for the JAX CLI's sake: every value fits the reference's "
            "compact pair layout (w2 logs a warning)",
        )
        sp.add_argument(
            "--checkpoint", metavar="PATH",
            help="periodically save the optimizer state to PATH and resume "
            "from it if it exists",
        )
        sp.add_argument(
            "--mesh", choices=["auto", "single"], default="auto",
            help="auto (default): shard the sequences over the ranks, one process "
            "per card: under torchrun --nproc_per_node=K, or started here with "
            "--device cuda when K > 1 cards are visible; single: one device",
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

    sw = subparsers.add_parser(
        "warmup",
        help="build the CUDA kernels a plmdca run at this MSA's shapes loads into "
        "the build cache (no compute); the next plmdca process starts built",
    )
    sw.add_argument("biomolecule", choices=["protein", "PROTEIN", "rna", "RNA"])
    sw.add_argument("msa_file")
    sw.add_argument("--seqid", type=float)
    sw.add_argument("--max_iterations", type=int)
    sw.add_argument("--seq_block", type=int)
    sw.add_argument("--precision", choices=["auto", "bfloat16", "float32"])
    sw.add_argument("--chunk_size", type=int)
    sw.add_argument("--param_space", choices=["auto", "w2", "compact"], default="auto")
    sw.add_argument(
        "--mesh", choices=["auto", "single"], default="auto",
        help="the compute_* --mesh mode to warm for (every rank loads the same "
        "libraries)",
    )
    sw.add_argument("--device", default="cuda",
                    help="cuda, cuda:K or cpu (the CPU builds nothing)")
    sw.add_argument("--verbose", action="store_true")
    sb = subparsers.add_parser(
        "compute_fn_batch",
        help="FN scores for many MSA families, fitted in lock-step per (N, L) bucket",
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
        help="fit every family in one lock-step batch at the batch maxima "
        "instead of one batch per (N, L) power-of-two bucket",
    )
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
    if verbose:
        configure_logging()
    mesh, device = launch_mesh(mesh, device)
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
        precision=precision,
        mesh=mesh,
        param_space=param_space,
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
    writer = mesh is None or mesh.rank == 0  # under a mesh, rank 0 writes
    if writer:
        dca_utilities.create_directories(output_dir)
    write_outputs(inst, the_command, msa_file, output_dir, apc=apc,
                  ranked_by=ranked_by, linear_dist=linear_dist,
                  num_site_pairs=num_site_pairs, seqbackmapper=seqbackmapper,
                  write=writer)
    return inst


def write_outputs(inst, the_command, msa_file, output_dir, *, apc=False,
                  ranked_by=None, linear_dist=None, num_site_pairs=None,
                  seqbackmapper=None, write=True):
    """Compute what ``the_command`` asks of the engine ``inst`` and write its
    files into ``output_dir`` (``pydca_tpu/cli/plmdca_main.py:199-265``).
    ``write=False`` computes the same and writes nothing (a rank other than
    0 of a mesh)."""
    param_metadata = dca_utilities.plmdca_param_metadata(inst)
    emit = _writer(write)

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
        emit(dca_utilities.write_sorted_dca_scores,
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
        emit(dca_utilities.write_sorted_dca_scores,
            path, scores, metadata=param_metadata, score_type=score_type
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
    """N families -> lock-step fits -> per-family ranked score files
    (``pydca_tpu/cli/plmdca_main.py:268-344``): one lock-step batch per
    (N, L) bucket through ``family_plm_fit_bucketed``, or, with
    ``bucket=False`` (``--no_bucket``), every family in one batch through
    ``family_plm_fit`` and ``family_plm_scores``, as the JAX CLI does.
    Returns a :class:`~pydca_tpu_torch.family.BatchRun`."""
    if verbose:
        configure_logging()
    timers = StageTimers()
    with timers.stage("read"):
        msas = [read_msa(f, biomolecule) for f in msa_files]
    seqid_v = 0.8 if seqid is None else float(seqid)
    iters = 100 if max_iterations is None else int(max_iterations)
    fits = [None] * len(msas)
    batches = []

    def record(f, st, batch):
        if not batches or batches[-1] is not batch:
            batches.append(batch)
        fits[f] = FamilyFit(st.k, st.n_evals, len(batches) - 1)
        logger.info("family %d (N=%d, L=%d): %d iterations, %d evaluations, lock-step batch %d",
                    f, msas[f].num_seqs, msas[f].seqs_len, st.k, st.n_evals, len(batches) - 1)

    with timers.stage("compute"):
        if bucket:
            scores_per_family, stats_d = family_plm_fit_bucketed(
                msas, seqid=seqid_v, max_iterations=iters, apc=apc, device=device,
                progress_fn=record,
            )
            waste = stats_d["bucketed_waste"]
            what = f"{stats_d['num_buckets']} buckets"
        else:
            batch = FamilyBatch(msas)
            thetas, _ = family_plm_fit(batch, seqid=seqid_v, max_iterations=iters,
                                       device=device, progress_fn=record)
            scores_per_family = family_plm_scores(batch, thetas, apc=apc)
            del thetas
            waste = padded_flop_stats(msas)["single_block_waste"]
            what = "one block (--no_bucket)"
    iterations = sum(f.num_iters for f in fits)
    syncs = sum(b.host_syncs for b in batches)
    logger.info("family batch: %d families in %s, %d lock-step batches at (N, L) %s: %d "
                "iterations, %d evaluations, %.3f s of fits, %d host syncs (%.2f a "
                "family-iteration), %d lane-iterations run; padded products %.2fx the "
                "useful FLOPs", len(msas), what, len(batches),
                ", ".join(f"{b.lanes} x {b.shape}" for b in batches), iterations,
                sum(f.n_evals for f in fits), sum(b.seconds for b in batches), syncs,
                syncs / max(iterations, 1), sum(b.lane_iterations for b in batches), waste)
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
    return BatchRun(paths, fits, batches, timers)


def run_warmup(args) -> float:
    """``plmdca warmup``: read the MSA (its post-dedup N, L, q) and build
    what a run at those shapes loads; prints the JAX CLI's line."""
    from ..plm import resolve_precision
    from ..warmup import warmup_plm

    if args.verbose:
        configure_logging()
    msa = read_msa(args.msa_file, args.biomolecule)
    dt = warmup_plm(
        msa.num_seqs, msa.seqs_len, msa.q,
        seqid=0.8 if args.seqid is None else args.seqid,
        max_iterations=100 if args.max_iterations is None else args.max_iterations,
        seq_block=args.seq_block,
        mm_bf16=resolve_precision(args.precision),
        chunk_size=50 if args.chunk_size is None else args.chunk_size,
        param_space=args.param_space,
        mesh=None if args.mesh == "single" else args.mesh,
        device=args.device,
    )
    print(f"warmed plmDCA cache for N={msa.num_seqs}, L={msa.seqs_len}, "
          f"q={msa.q} ({dt:.1f} s build)")
    return dt


def run_plm_dca(argv=None):
    """The ``plmdca`` CLI on ``argv`` (default ``sys.argv[1:]``); returns
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
            max_iterations=args.max_iterations,
            output_dir=args.output_dir,
            apc=args.apc,
            verbose=args.verbose,
            bucket=not args.no_bucket,
            device=args.device,
        )
    world = spawn_world(args.mesh, args.device)
    if world:
        code = spawn_cli(run_plm_dca, argv, world, args.device)
        if code:
            raise SystemExit(code)
        return None
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


def main(argv=None) -> None:
    """The ``plmdca-torch`` console script: :func:`run_plm_dca` without its
    result, so that a finished run exits 0 (a failed rank raises
    ``SystemExit`` with its code)."""
    run_plm_dca(argv)


if __name__ == "__main__":
    main()
