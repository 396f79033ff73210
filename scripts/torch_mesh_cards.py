"""The port's data parallelism over the sequences on every visible card.

    torchrun --standalone --nproc_per_node=<cards> scripts/torch_mesh_cards.py

(from the repository root, with ``env PYTHONPATH=.`` where the repository is
not installed).  One rank per card (``cuda:LOCAL_RANK``) in an NCCL group;
each rank holds a stripe of the rows.  Three cases, at the widths of
``chip_smoke.py``'s phases 3, 6 and 12 and from the same seeds:

- ``plm``: ``PlmDCA`` at 16384 x 195, q 21, 100 iterations (fused);
- ``mf``: ``MeanFieldDCA`` at 4096 x 1000, q 21;
- ``deep``: ``PlmDCA`` at 10^5 x 1000, q 21, 2 iterations, streamed over
  blocks of 12782 sequences.

Every rank first builds the kernels and runs the small shapes on its own
card, untimed (a warm-up: the builds, cuBLAS and cuSOLVER handles).  For
each case every rank draws the family on the host, rank 0 runs the
one-card engine on its card while the other ranks wait at a barrier, and
after a second barrier every rank runs the sharded engine.
Rank 0 prints one line a case: the walls of both, the sharded run's
collectives (count and seconds, the device synchronised around each),
peak memory, and the agreement with one card: weights exactly, θ and the
FN-APC ranking (Spearman, top-20 overlap) at the bars of ``chip_smoke.py``
phase 16.

A fourth case, ``cli``, compares the two launches of the CLI over every
card: rank 0 runs ``plmdca compute_fn --apc --mesh auto --device cuda`` on
the ``plm`` family as one process (which starts one rank a card itself,
``pydca_tpu_torch.parallel.spawn``) and then ``torchrun
--nproc_per_node=<cards>`` on the same argv, while the other ranks wait;
the two files must be equal byte for byte, and it prints both walls.

A fifth case, ``model``, runs the model-sharded mean-field solve:
``mfdca_sharded`` on a (1, K) and, for an even K of 4 or more, a (K/2, 2)
('data', 'model') grid, at 4096 x 1000, q 21 (D = 20000) and 4096 x 2000,
q 21 (D = 40000, whose Gram is a 7 GB (Lq)^2 buffer on every rank), after
an untimed run of both grids at small shapes (NCCL sets up a group's
communicator, and its peer connections for the all-to-all, at their
first use).  Rank 0 first runs the one-card engine
(``MeanFieldDCA.compute_couplings``).
One line a grid and shape: both walls, the stages (the sharded run's
``gram``, ``corr``, ``cholesky``, ``tri_inv``, ``syrk``, ``score``), every
rank's peak memory over the run and over the solve (C resident), the
collectives, the FN-APC rank bar against one card and rank 0's rows of the
couplings against one card's.

``--device cpu --small`` runs the same on the CPU under gloo at small shapes, to rehearse a launch
without a card (the ``cli`` case's one process calls ``spawn_cli`` with
gloo ranks there).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from datetime import timedelta

import tempfile

import torch
import torch.distributed as dist

from pydca_tpu_torch import alphabets, score
from pydca_tpu_torch.device import set_precision
from pydca_tpu_torch.io.fasta import MSA
from pydca_tpu_torch.meanfield import MeanFieldDCA
from pydca_tpu_torch.ops import cuda_kernels as ck
from pydca_tpu_torch.parallel import init_distributed, make_mesh, mfdca_sharded, shard_msa
from pydca_tpu_torch.plm import PlmDCA
from pydca_tpu_torch.profiling import StageTimers
from pydca_tpu_torch.synthetic import (
    planted_family, spearman, top_k_overlap, write_family_fasta,
)

CASES = {  # name: (N, L, q, seed, iterations, seq_block)
    "plm": (16384, 195, 21, 0, 100, None),
    "mf": (4096, 1000, 21, 2, None, None),
    "deep": (100000, 1000, 21, 12, 2, 12782),
}
SMALL = {"plm": (1201, 40, 21, 0, 30, None), "mf": (803, 60, 21, 2, None, None),
         "deep": (2001, 50, 21, 12, 2, 256)}
MODEL = {"model_d20000": (4096, 1000, 21, 2, None, None),
         "model_d40000": (4096, 2000, 21, 2, None, None)}
SMALL_MODEL = {"model_d1200": (803, 60, 21, 2, None, None),
               "model_d4200": (803, 210, 21, 2, None, None)}
THETA_TOL = (2e-3, 2e-3)  # (rtol, atol) of theta against one card: float32 sums in other orders


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_gib(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0


def reset(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    ck.identity_counts.launches = ck.weighted_gram.launches = 0


def draw(shape):
    n, l, q, seed, _, _ = shape
    return MSA(data=planted_family(n, l, q, seed=seed, n_pairs=20)[0],
               alphabet=alphabets.PROTEIN)


def run_case(name, shape, msa, dev, mesh):
    """The engine of case ``name`` on one device (``mesh=None``) or over
    the mesh: (wall s, stage timers, weights, theta or couplings, sorted FN-APC)."""
    n, l, q, seed, iters, block = shape
    reset(dev)
    t0 = time.perf_counter()
    if name == "mf":
        inst = MeanFieldDCA(msa, "protein", device=dev, mesh=mesh)
        fn_apc = inst.compute_sorted_FN_APC()
        params, weights = inst.compute_couplings(), inst.get_sequences_weight()
        stages = ("weights", "gram", "corr", "inverse", "score")
    else:
        inst = PlmDCA(msa, "protein", max_iterations=iters, device=dev, mesh=mesh,
                      seq_block=block)
        params, weights = inst._theta(), inst.compute_seqs_weight()
        p = l * (l - 1) // 2
        blocks = params[l * q:].reshape(p, q, q)[:, : q - 1, : q - 1]
        fn_apc = score.sorted_scores(score.apc(score.frobenius_norms(blocks), l), l)
        stages = ("weights", "fit")
    sync(dev)
    wall = time.perf_counter() - t0
    timers = {s: round(inst.timers.elapsed(s), 4) for s in stages}
    if name != "mf":
        res = inst.fit_result
        timers.update(iterations=res.num_iters, evaluations=res.n_evals)
    timers.update(peak_gib=round(peak_gib(dev), 3), identity_counts=ck.identity_counts.launches,
                  weighted_gram=ck.weighted_gram.launches)
    return wall, timers, weights, params, fn_apc


class SolveTimers(StageTimers):
    """Stage timers that keep the peak device memory from the start of the
    stage ``first`` to the end of the stage ``last`` (``peak``), and the
    peak before it (``before``)."""

    def __init__(self, dev, first: str, last: str):
        super().__init__()
        self.dev, self.first, self.last, self.peak, self.before = dev, first, last, 0, 0

    @contextlib.contextmanager
    def stage(self, name):
        if name == self.first and self.dev.type == "cuda":
            self.before = peak_gib(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        with StageTimers.stage(self, name):
            yield
        if name == self.last:
            self.peak = peak_gib(self.dev)


def grids(world):
    """The ('data', 'model') grids of the ``model`` case."""
    out = [(1, world)]
    if world % 2 == 0 and world >= 4:
        out.append((world // 2, 2))
    return out


def model_case(name, shape, dev, rank, world, meshes):
    """The ``model`` case at one shape: rank 0's one-card engine, then
    ``mfdca_sharded`` on each grid of ``meshes``; rank 0 returns one record
    a grid.  Rank 0 keeps the one-card couplings on the host, so every
    rank's peak memory is its sharded run's alone."""
    n, l, q, _, _, _ = shape
    msa = draw(shape)
    one = None
    if rank == 0:
        reset(dev)
        inst = MeanFieldDCA(msa, "protein", device=dev)
        inst.timers = SolveTimers(dev, "inverse", "inverse")
        t0 = time.perf_counter()
        cpl = inst.compute_couplings()
        sync(dev)
        wall = time.perf_counter() - t0
        cpl = cpl.cpu()
        one = dict(wall=round(wall, 4), peak_gib=round(max(peak_gib(dev), inst.timers.before), 3),
                   solve_peak_gib=round(inst.timers.peak, 3),
                   stages={s: round(inst.timers.elapsed(s), 4)
                           for s in ("weights", "gram", "corr", "inverse", "score")})
        scores = inst.compute_sorted_FN_APC()
        del inst
    dist.barrier()
    recs = []
    for (nd, nm), mesh in meshes.items():
        mesh.collectives.clear()
        codes, _, valid = shard_msa(mesh, msa.data)
        reset(dev)
        timers = SolveTimers(dev, "cholesky", "syrk")
        t0 = time.perf_counter()
        fn, apc, rows = mfdca_sharded(codes, biomolecule_q=q, valid=valid, mesh=mesh,
                                      return_couplings=True, timers=timers)
        sync(dev)
        wall = time.perf_counter() - t0
        mine = dict(wall=round(wall, 4), peak_gib=round(max(peak_gib(dev), timers.before), 3),
                    solve_peak_gib=round(timers.peak, 3),
                    stages={s: round(timers.elapsed(s), 4) for s in (
                        "weights", "gram", "corr", "cholesky", "tri_inv", "syrk", "score")})
        every = [None] * world
        dist.all_gather_object(every, mine)
        if rank == 0:
            got = score.sorted_scores(apc, l)
            err = float((rows.rows.cpu() - cpl[rows.start : rows.stop]).abs().max()
                        / cpl.abs().max())
            recs.append(dict(
                case=name, shape=[n, l, q], grid=[nd, nm], one_card=one, ranks=every,
                collectives={k: [c, e, round(t, 4), b]
                             for k, (c, e, t, b) in mesh.collectives.items()},
                spearman=round(spearman(scores, got, l), 6), top20=top_k_overlap(scores, got, 20),
                couplings_rows_rel_err=err))
        del fn, apc, rows
        dist.barrier()
    return recs


def clean_env():
    """This process's environment without the variables of the torchrun
    that launched it, and with the checkout on the path."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in TORCHRUN_VARS and not k.startswith("TORCHELASTIC")}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    return env


TORCHRUN_VARS = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "GROUP_RANK",
                 "GROUP_WORLD_SIZE", "ROLE_RANK", "ROLE_NAME", "ROLE_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT")


def cli_case(shape, world, device) -> dict:
    """Rank 0: the ``plm`` family's ``plmdca compute_fn --apc --mesh auto``
    launched as one process over every card and under torchrun; both
    walls and whether the two files are equal."""
    n, l, q, _, iters, _ = shape
    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "plm.fa")
        write_family_fasta(fa, draw(shape).data, alphabets.PROTEIN)
        argv = ["compute_fn", "protein", fa, "--apc", "--max_iterations", str(iters),
                "--mesh", "auto", "--device", device]
        env = clean_env()
        if device == "cuda":
            one = [sys.executable, "-m", "pydca_tpu_torch.cli.plmdca_main"]
        else:  # the CPU is not "every card": the rehearsal calls the spawner itself
            one = [sys.executable, "-c", "import sys; from pydca_tpu_torch.cli.plmdca_main import "
                   "run_plm_dca; from pydca_tpu_torch.parallel import spawn_cli; "
                   f"sys.exit(spawn_cli(run_plm_dca, sys.argv[1:], {world}, 'cpu'))"]
        many = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                f"--nproc_per_node={world}", "-m", "pydca_tpu_torch.cli.plmdca_main"]
        walls, files = {}, {}
        for name, cmd in (("one_process", one), ("torchrun", many)):
            out = os.path.join(tmp, name)
            t0 = time.perf_counter()
            proc = subprocess.run(cmd + argv + ["--output_dir", out], env=env,
                                  capture_output=True, text=True, timeout=900)
            walls[name] = round(time.perf_counter() - t0, 4)
            if proc.returncode != 0:
                raise RuntimeError(f"cli case, {name} failed (exit {proc.returncode}):\n"
                                   f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
            names = os.listdir(out)
            if len(names) != 1:
                raise RuntimeError(f"cli case, {name}: {len(names)} files, expected rank 0's one")
            with open(os.path.join(out, names[0]), "rb") as fh:
                files[name] = fh.read()
    return dict(case="cli", shape=[n, l, q], ranks=world, one_process_wall=walls["one_process"],
                torchrun_wall=walls["torchrun"],
                files_equal=files["one_process"] == files["torchrun"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--small", action="store_true", help="small shapes (a rehearsal)")
    args = ap.parse_args()
    cases = SMALL if args.small else CASES
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_mesh_cards: no card visible", file=sys.stderr)
            return 1
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        init_distributed("nccl", device_id=dev, timeout=timedelta(seconds=900))
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
        init_distributed("gloo", timeout=timedelta(seconds=900))
    set_precision()
    rank, world = dist.get_rank(), dist.get_world_size()
    where = "CPU (rehearsal)" if dev.type == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if rank == 0:
        print(f"{where}; torch {torch.__version__}; {world} ranks on "
              f"{torch.cuda.device_count() if dev.type == 'cuda' else 0} visible cards", flush=True)
    for name, shape in SMALL.items():  # the warm-up, untimed
        run_case(name, shape, draw(shape), dev, None)
    # the grids once, their communicators set up by an untimed run at the small shapes
    meshes = {g: make_mesh(*g, device=dev) for g in grids(world)}
    for mesh in meshes.values():
        mesh.timed = True
    for name, shape in SMALL_MODEL.items():
        model_case(name, shape, dev, rank, world, meshes)
    for name, shape in (SMALL_MODEL if args.small else MODEL).items():
        for rec in model_case(name, shape, dev, rank, world, meshes):
            print(json.dumps(rec), flush=True)
        reset(dev)
    for name, shape in cases.items():
        msa = draw(shape)
        one = run_case(name, shape, msa, dev, None) if rank == 0 else None
        dist.barrier()
        mesh = make_mesh(device=dev)
        mesh.timed = True
        many = run_case(name, shape, msa, dev, mesh)
        dist.barrier()
        if rank != 0:
            continue
        wall1, t1, w1, p1, s1 = one
        wallk, tk, wk, pk, sk = many
        n, l = shape[0], shape[1]
        rec = dict(case=name, shape=shape[:3], ranks=world, one_card_wall=round(wall1, 4),
                   sharded_wall=round(wallk, 4), one_card=t1, sharded=tk,
                   collectives={k: [c, e, round(s, 4), b]
                                for k, (c, e, s, b) in mesh.collectives.items()},
                   weights_equal=bool(torch.equal(w1, wk)),
                   spearman=round(spearman(s1, sk, l), 6), top20=top_k_overlap(s1, sk, 20))
        if name == "mf":
            rec["couplings_max_abs"] = float((p1 - pk).abs().max())
        else:
            diff = (p1 - pk).abs()
            rec["theta_max_abs"] = float(diff.max())
            rec["theta_within"] = bool((diff <= THETA_TOL[1] + THETA_TOL[0] * p1.abs()).all())
        print(json.dumps(rec), flush=True)
        del one, many
    reset(dev)
    ok = True
    if rank == 0:
        rec = cli_case((SMALL if args.small else CASES)["plm"], world, args.device)
        print(json.dumps(rec), flush=True)
        ok = rec["files_equal"]
    dist.barrier()
    dist.destroy_process_group()
    if not ok:
        print("torch_mesh_cards: the one-process run's file differs from torchrun's",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
