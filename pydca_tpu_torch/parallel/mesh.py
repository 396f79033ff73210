"""The mesh of a multi-process run: a ('data', 'model') grid of ranks, one
process per rank, each on its own device.

Port of ``pydca_tpu/parallel/mesh.py`` for ``torch.distributed``.  On the
TPU the mesh is a grid of devices under one program and GSPMD inserts the
collectives; here each rank is a process, and the collectives are explicit.
Rank ``r = d * n_model + m`` sits at data index ``d`` and model index ``m``
(JAX's ``np.array(devices).reshape(n_data, n_model)``).

- The ``data`` axis shards the alignment's rows: a rank holds the stripe of
  its data index, the same stripe in every model replica.  The sums over
  sequences (:meth:`DataMesh.sum_` over the data group) are the identity
  counts, ``fi`` and Meff, the Gram, the plm loss, its gradient and each
  line-search trial's ``(phi, phi')``.
- The ``model`` axis shards the rows of the mean-field correlation and
  coupling matrices (:meth:`DataMesh.broadcast_`,
  :meth:`DataMesh.reduce_scatter_rows`, :meth:`DataMesh.all_to_all_rows`,
  and ``sum_`` and ``gather_rows`` with ``axis="model"``;
  :mod:`pydca_tpu_torch.ops.linalg`).  The
  plm fit is replicated over it.  Ranks that share a card take gloo, which
  runs all four on CUDA tensors itself, through the host (torch 2.11 on
  an H100); across cards, NCCL.

Everything else is replicated, bitwise equal on every rank.
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
from ..profiling import span

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

@dataclass
class DataMesh:
    """The process groups of a run and this rank's place in its grid.

    ``group``, ``rank`` and ``world_size`` are the data group's (the ranks
    that share this rank's model index); ``model_group``, ``model_rank``
    and ``model_size`` the model group's (the ranks that share its data
    index).  A group of one rank is ``None``: its collectives are the
    identity.  ``collectives`` counts, per name, ``[calls, elements,
    seconds, bytes]`` of every collective the run made (the seconds only
    when ``timed``, which synchronises the device around each one so its
    time is the collective's alone).  Each collective is the span
    ``pydca/mesh/<name>`` (:func:`~pydca_tpu_torch.profiling.span`).
    """

    group: Optional[object]
    rank: int
    world_size: int
    device: torch.device
    timed: bool = False
    collectives: Dict[str, List[float]] = field(default_factory=dict)
    model_group: Optional[object] = None
    model_rank: int = 0
    model_size: int = 1

    @property
    def leader(self) -> bool:
        """Whether this is the grid's first rank (the one that writes files)."""
        return self.rank == 0 and self.model_rank == 0

    def _group(self, axis: str):
        if axis == "data":
            return self.group, self.world_size
        if axis == "model":
            return self.model_group, self.model_size
        raise ValueError(f"unknown mesh axis {axis!r}; use 'data' or 'model'")

    def _record(self, name: str, numel: int, nbytes: int, seconds: float) -> None:
        rec = self.collectives.setdefault(name, [0, 0, 0.0, 0])
        rec[0] += 1
        rec[1] += numel
        rec[2] += seconds
        rec[3] += nbytes

    def _run(self, name: str, t: torch.Tensor, fn, copies: int = 1) -> None:
        """Run the collective ``fn`` over the group, as the span
        ``mesh/<name>``, and count it: ``copies`` times ``t``'s elements."""
        if self.timed:
            sync(self.device)
        t0 = time.perf_counter()
        with span("mesh/" + name):
            fn()
        if self.timed:
            sync(self.device)
        numel = t.numel() * copies
        self._record(name, numel, numel * t.element_size(),
                     time.perf_counter() - t0 if self.timed else 0.0)

    def sum_(self, t: torch.Tensor, name: str, axis: str = "data") -> torch.Tensor:
        """Sum ``t`` over the axis's ranks, in place; returns ``t``."""
        group, _ = self._group(axis)
        if group is not None:
            self._run(name, t, lambda: dist.all_reduce(t, group=group))
        return t

    def max_(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """Elementwise maximum of ``t`` over the data ranks, in place."""
        if self.group is not None:
            self._run(name, t, lambda: dist.all_reduce(
                t, op=dist.ReduceOp.MAX, group=self.group))
        return t

    def gather_rows(self, t: torch.Tensor, name: str, axis: str = "data") -> torch.Tensor:
        """The axis's ranks' equal-sized stripes of ``t`` stacked along dim
        0, in rank order (every rank gets the whole)."""
        group, size = self._group(axis)
        if group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(size)]
        src = t.contiguous()
        self._run(name, t, lambda: dist.all_gather(parts, src, group=group), size)
        return torch.cat(parts)

    def broadcast_(self, t: torch.Tensor, src: int, name: str) -> torch.Tensor:
        """``t`` of model rank ``src`` into ``t`` on every rank of the model
        axis, in place (``t`` contiguous); returns ``t``."""
        group = self.model_group
        if group is not None:
            root = dist.get_global_rank(group, src)
            self._run(name, t, lambda: dist.broadcast(t, src=root, group=group))
        return t

    def reduce_scatter_rows(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The sum of ``t`` over the model axis, cut into equal stripes along
        dim 0: model rank k gets stripe k (``psum_scatter(...,
        scatter_dimension=0, tiled=True)``)."""
        if self.model_group is None:
            return t
        out = torch.empty((t.shape[0] // self.model_size,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        src = t.contiguous()
        self._run(name, t, lambda: _reduce_scatter(out, src, self.model_group))
        return out

    def all_to_all_rows(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """``t`` cut into equal stripes along dim 0, stripe k sent to model
        rank k; returns what every model rank sent this one, stacked in rank
        order."""
        if self.model_group is None:
            return t
        src = t.contiguous()
        out = torch.empty_like(src)
        self._run(name, t, lambda: dist.all_to_all_single(out, src, group=self.model_group))
        return out

    def barrier(self) -> None:
        """Wait for every rank of the grid (the data group, then the model group)."""
        for group in (self.group, self.model_group):
            if group is not None:
                dist.barrier(group=group)

    def stripe_rows(self, n: int):
        """``(n_pad, start, stop)``: N padded to a multiple of the data axis
        and this rank's rows ``[start, stop)`` of the padded alignment."""
        per = -(-n // self.world_size)
        return per * self.world_size, self.rank * per, (self.rank + 1) * per


def _reduce_scatter(out: torch.Tensor, src: torch.Tensor, group) -> None:
    # the name of the tensor form since torch 2.13; reduce_scatter_tensor before
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, src, group=group)


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    *,
    group=None,
    device,
) -> DataMesh:
    """A ('data', 'model') grid over the ranks of ``group`` (default: the
    default process group when one is initialised, else one process
    without collectives).

    ``n_data`` defaults to the world size over ``n_model``;
    ``n_data * n_model`` must equal the world size (one rank per process,
    one device per rank), or ``ValueError``.  Rank ``r`` of ``group`` sits
    at ``(r // n_model, r % n_model)``.  With ``n_model > 1`` every rank
    creates every data group and every model group, in the same order (a
    group of one rank is not created); ``n_model = 1`` gives the data mesh
    over ``group`` itself.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        rank, world = 0, 1
    else:
        rank, world = dist.get_rank(group), dist.get_world_size(group)
    n_model = int(n_model)
    if n_model < 1 or world % n_model:
        raise ValueError(f"a model axis of {n_model} does not divide the group's {world} ranks")
    n_data = world // n_model if n_data is None else int(n_data)
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} ranks; the group "
                         f"has {world}")
    if n_model == 1:
        return DataMesh(group=group, rank=rank, world_size=world, device=dev)
    ranks = dist.get_process_group_ranks(group)
    d, m = divmod(rank, n_model)
    data_group = model_group = None
    if n_data > 1:
        for col in range(n_model):
            g = dist.new_group([ranks[r * n_model + col] for r in range(n_data)])
            if col == m:
                data_group = g
    for row in range(n_data):
        g = dist.new_group(ranks[row * n_model:(row + 1) * n_model])
        if row == d:
            model_group = g
    return DataMesh(group=data_group, rank=d, world_size=n_data, device=dev,
                    model_group=model_group, model_rank=m, model_size=n_model)


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
