"""The data mesh of a multi-process run: one process per rank, each holding
a contiguous stripe of the alignment's rows on its own device.

Port of ``pydca_tpu/parallel/mesh.py`` for ``torch.distributed``.  On the
TPU the mesh is a grid of devices under one program and GSPMD inserts the
``psum`` over its ``data`` axis; here each rank is a process, and the sums
over sequences are explicit collectives (:meth:`DataMesh.sum_`): the
identity counts, ``fi`` and Meff, the Gram, the plm loss, its gradient and
each line-search trial's ``(phi, phi')``.  Everything else is replicated,
bitwise equal on every rank.

Only the ``data`` axis is ported: a ``model`` axis above 1 (the
model-sharded mean-field solve) raises naming its ROADMAP item.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device, sync

logger = logging.getLogger(__name__)

__all__ = [
    "DataMesh",
    "make_mesh",
    "reject_several_cards",
    "resolve_mesh",
    "several_cards",
    "shard_msa",
    "stripe",
    "torchrun_world",
]

# the ROADMAP Queue 1 item that carries what is not ported of the mesh
MODEL_AXIS_ITEM = "ROADMAP Queue 1 #16"


@dataclass
class DataMesh:
    """The process group of a data-parallel run and this rank's place in it.

    ``group`` is ``None`` for a one-process mesh without a process group
    (its sums are the identity).  ``collectives`` counts, per name, the
    calls, elements and (when ``timed``) seconds of every collective the
    run made; ``timed`` synchronises the device around each one so its
    time is the collective's alone.
    """

    group: Optional[object]
    rank: int
    world_size: int
    device: torch.device
    timed: bool = False
    collectives: Dict[str, List[float]] = field(default_factory=dict)

    def _record(self, name: str, numel: int, seconds: float) -> None:
        rec = self.collectives.setdefault(name, [0, 0, 0.0])
        rec[0] += 1
        rec[1] += numel
        rec[2] += seconds

    def _run(self, name: str, numel: int, fn) -> None:
        """Run the collective ``fn`` over the group and count it."""
        if self.timed:
            sync(self.device)
        t0 = time.perf_counter()
        fn()
        if self.timed:
            sync(self.device)
        self._record(name, numel, time.perf_counter() - t0 if self.timed else 0.0)

    def sum_(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        if self.group is not None:
            self._run(name, t.numel(), lambda: dist.all_reduce(t, group=self.group))
        return t

    def max_(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """Elementwise maximum of ``t`` over the ranks, in place."""
        if self.group is not None:
            self._run(name, t.numel(), lambda: dist.all_reduce(
                t, op=dist.ReduceOp.MAX, group=self.group))
        return t

    def gather_rows(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The ranks' equal-sized stripes of ``t`` stacked along dim 0, in
        rank order (every rank gets the whole)."""
        if self.group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        src = t.contiguous()
        self._run(name, t.numel() * self.world_size,
                  lambda: dist.all_gather(parts, src, group=self.group))
        return torch.cat(parts)

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def stripe_rows(self, n: int):
        """``(n_pad, start, stop)``: N padded to a multiple of the world size
        and this rank's rows ``[start, stop)`` of the padded alignment."""
        per = -(-n // self.world_size)
        return per * self.world_size, self.rank * per, (self.rank + 1) * per


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    *,
    group=None,
    device,
) -> DataMesh:
    """A data mesh over ``group`` (default: the default process group when
    one is initialised, else one process without collectives).

    ``n_data`` defaults to the group's world size and must equal it: one
    rank per process, one device per rank.  ``n_model > 1`` (the
    model-sharded solve) is not ported.
    """
    if n_model != 1:
        raise NotImplementedError(
            f"a model axis of {n_model} (the model-sharded mean-field solve) is "
            f"not ported yet ({MODEL_AXIS_ITEM})"
        )
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        rank, world = 0, 1
    else:
        rank, world = dist.get_rank(group), dist.get_world_size(group)
    if n_data is not None and int(n_data) != world:
        raise ValueError(f"a data axis of {n_data} needs {n_data} ranks; the group has {world}")
    return DataMesh(group=group, rank=rank, world_size=world, device=dev)


def _distributed_world() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def several_cards(device) -> int:
    """The count of visible cards when ``device`` means every card (an
    unindexed ``cuda`` on a process that sees more than one), else 0.  A
    named card ``cuda:K`` is one device."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return 0
    count = torch.cuda.device_count()
    return count if count > 1 else 0


def reject_several_cards(device) -> None:
    """An engine is one process, one rank: under ``mesh="auto"`` a process
    without a process group that is asked for every card (unindexed
    ``cuda``) of several raises, naming the launches that run one rank a
    card.  A named card ``cuda:K`` runs on that card."""
    count = several_cards(device)
    if count:
        raise NotImplementedError(
            f"mesh='auto' on device 'cuda' in one process over {count} cards: the "
            "port's ranks are processes (the JAX package shards in one), and an "
            "engine's constructor does not start them; run the CLI (plmdca/mfdca "
            "... --mesh auto --device cuda starts one rank a card itself), launch "
            "one process a card with torchrun --nproc_per_node=<cards>, or name one "
            "card (cuda:K)"
        )


def resolve_mesh(mesh, device) -> Optional[DataMesh]:
    """``None`` -> one device; ``"auto"`` -> the default process group when
    one is initialised with a world size above 1, else one device (an
    unindexed ``cuda`` in a process that sees several cards raises:
    :func:`reject_several_cards`); a :class:`DataMesh` passes through (the
    twin of ``pydca_tpu/meanfield.py:107-119``)."""
    if mesh is None:
        return None
    if isinstance(mesh, str):
        if mesh == "single":
            return None
        if mesh != "auto":
            raise ValueError(f"unknown mesh {mesh!r}; use 'auto', 'single' or a DataMesh")
        if _distributed_world() > 1:
            return make_mesh(device=device)
        reject_several_cards(device)
        return None
    if not isinstance(mesh, DataMesh):
        raise TypeError(f"mesh must be None, 'auto', 'single' or a DataMesh, got {type(mesh)}")
    return mesh


def stripe(mesh: DataMesh, a, n: int, pad_value=0):
    """This rank's stripe of an (N, ...) host array or tensor, padded past N
    with ``pad_value`` rows (a tensor stays on its device)."""
    n_pad, start, stop = mesh.stripe_rows(n)
    rows = a[start:min(stop, n)]
    extra = (stop - start) - rows.shape[0]
    if extra == 0:
        return rows
    if isinstance(a, torch.Tensor):
        pad = torch.full((extra,) + tuple(a.shape[1:]), pad_value, dtype=a.dtype, device=a.device)
        return torch.cat([rows, pad])
    pad = np.full((extra,) + a.shape[1:], pad_value, dtype=a.dtype)
    return np.concatenate([rows, pad])


def shard_msa(mesh: DataMesh, msa, weights=None):
    """This rank's stripe of an (N, L) alignment for the mesh's data axis.

    N is padded up to a multiple of the world size with rows of code 0,
    weight 0 and ``valid = False`` (``pydca_tpu/parallel/mesh.py:78-103``),
    which leaves every weighted statistic (fi, the Gram, the plm loss)
    unchanged; the mask keeps the pads out of the identity counts.
    Returns ``(codes, weights, valid)`` on the mesh's device: int8 codes,
    the given weights' float dtype (float64 stays float64; ones in float32
    when none are given) and the bool mask.
    """
    n = msa.shape[0]
    if isinstance(msa, torch.Tensor):
        codes = stripe(mesh, msa, n).to(mesh.device, torch.int8)
    else:
        codes = torch.from_numpy(np.ascontiguousarray(stripe(mesh, np.asarray(msa), n)))
        codes = codes.to(mesh.device, torch.int8)
    if weights is None:
        weights = torch.ones(n, dtype=torch.float32, device=mesh.device)
    weights = torch.as_tensor(weights, device=mesh.device)
    if not weights.is_floating_point():
        weights = weights.to(torch.float32)
    w = stripe(mesh, weights, n)
    valid = stripe(mesh, torch.ones(n, dtype=torch.bool, device=mesh.device), n, False)
    return codes, w, valid


def torchrun_world() -> int:
    """The world size ``torchrun`` gave this process (1 outside it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))
