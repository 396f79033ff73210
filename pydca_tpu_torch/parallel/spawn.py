"""One process that drives every card: a CLI run starts its ranks itself.

The JAX CLIs' ``--mesh auto`` shards over every visible device in one
process (``pydca_tpu/cli/plmdca_main.py:77-82``).  The port's ranks are
processes (:mod:`pydca_tpu_torch.parallel.mesh`), so a CLI process asked
for every card (``--mesh auto --device cuda``, unindexed) of K > 1, with
no process group and not under ``torchrun``, starts K rank processes
(``torch.multiprocessing``, start method ``spawn``) that meet at a
``FileStore`` in a temporary directory, and waits for them.  Each rank
takes its rank, its card and NCCL, and runs the same argv through the
``torchrun`` path (:func:`~pydca_tpu_torch.parallel.fit.launch_mesh`);
rank 0 writes the files.  The parent exits with the first nonzero exit
code of any rank, whose error it prints; the other ranks are stopped.
"""

from __future__ import annotations

import logging
import os
import sys
import tempfile
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .fit import init_distributed
from .mesh import several_cards, torchrun_world

logger = logging.getLogger(__name__)

__all__ = ["spawn_cli", "spawn_world"]


def spawn_world(mesh: str, device: str) -> int:
    """K when a CLI run should start K ranks itself: ``--mesh auto``, an
    unindexed ``cuda``, no process group, not under ``torchrun``, and
    K > 1 visible cards; else 0 (one device, or the ``torchrun`` path)."""
    if mesh != "auto" or torchrun_world() > 1 or dist.is_initialized():
        return 0
    return several_cards(device)


def _rank_main(rank: int, run: Callable, argv: Sequence[str], world: int, device: str,
               store: str) -> None:
    """One rank: its card and process group, then the CLI on ``argv``."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world))
    dev = torch.device(device)
    group = dict(store=dist.FileStore(store, world), rank=rank, world_size=world)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        init_distributed("nccl", device_id=dev, **group)
    else:  # the CPU, or every rank on one named card (NCCL refuses that)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        init_distributed("gloo", **group)
    try:
        run(list(argv))
    finally:
        dist.destroy_process_group()


def spawn_cli(run: Callable, argv: Sequence[str], world: int, device: str) -> int:
    """Run a CLI's entry ``run`` (``plmdca_main.run_plm_dca`` or
    ``mfdca_main.run_meanfield_dca``; a module-level function, which the
    spawned ranks import by name) on ``argv`` in ``world`` rank processes
    and wait for them; returns 0, or the first nonzero exit code of a rank
    (the others are stopped).

    ``device``: ``"cuda"`` puts rank r on card r under NCCL; ``"cuda:K"``
    puts every rank on card K under gloo; ``"cpu"`` runs gloo on the CPU.
    ``argv`` should ask for the same device and ``--mesh auto``.
    """
    cli = run.__name__
    logger.info("starting %d ranks of %s on %s", world, cli, device)
    with tempfile.TemporaryDirectory(prefix="pydca_ranks_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(run, list(argv), world, device, os.path.join(tmp, "store")),
            nprocs=world, join=False, start_method="spawn",
        )
        try:
            while not ctx.join():
                pass
        except mp.ProcessExitedException as exc:
            print(f"{cli}: {exc}", file=sys.stderr, flush=True)
            return exc.exit_code or 1
        except mp.ProcessRaisedException as exc:  # the rank exited with 1
            print(f"{cli}: {exc}", file=sys.stderr, flush=True)
            return 1
    return 0
