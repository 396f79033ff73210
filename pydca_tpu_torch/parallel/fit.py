"""Distributed DCA entry points: process-group init and sequence-sharded fits.

Port of ``pydca_tpu/parallel/fit.py`` for ``torch.distributed``.  One
process per rank, each holding a contiguous stripe of the alignment's rows
on its own device (:mod:`pydca_tpu_torch.parallel.mesh`).  Every sum over
sequences is an explicit collective of the rank's partial sum; the rest of
the computation is replicated, so every rank ends with the same result,
bitwise.

Usage, one process per card (``torchrun --nproc_per_node=K script.py``)::

    from pydca_tpu_torch.parallel import (
        init_distributed, make_mesh, read_msa_distributed, weights_distributed,
        fit_plm_sharded)
    init_distributed(backend="nccl")
    mesh = make_mesh(device=f"cuda:{os.environ['LOCAL_RANK']}")
    sharded = read_msa_distributed(files, "protein")
    codes, w, valid = weights_distributed(sharded, 0.8, mesh)
    result = fit_plm_sharded(codes, weights=w, valid=valid, mesh=mesh)

Unlike the JAX package's ``fit_plm_sharded`` (``pydca_tpu/parallel/fit.py:
165, 221``), nothing here gathers the alignment onto one host: the sharded
fits take the rank's stripe already on its device.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import stats
from ..profiling import synced_stage
from ..ops.lbfgs import LBFGSResult
from .mesh import DataMesh, make_mesh, reject_several_cards, torchrun_world

logger = logging.getLogger(__name__)

__all__ = [
    "init_distributed",
    "launch_mesh",
    "fit_plm_sharded",
    "sequence_weights_sharded",
    "mfdca_sharded",
]

DEFAULT_TIMEOUT_S = 300  # a rank that stops answering fails the run, never hangs it


def init_distributed(backend: Optional[str] = None, **kwargs):
    """``torch.distributed.init_process_group`` with logging; idempotent.

    ``backend`` is the caller's choice (``"nccl"`` for CUDA tensors,
    ``"gloo"`` for CPU tensors, or CUDA tensors staged through the host
    when two ranks share a card, which NCCL refuses); ``None`` is torch's
    default pair (gloo for CPU tensors, NCCL for CUDA tensors).  Nothing
    retries another backend.  Without an ``init_method`` or ``store``,
    torch reads torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``).  ``timeout`` defaults to
    ``DEFAULT_TIMEOUT_S`` seconds.  Returns the default group.
    """
    if dist.is_initialized():
        logger.info("torch.distributed already initialised (%s, rank %d of %d)",
                    dist.get_backend(), dist.get_rank(), dist.get_world_size())
        return dist.group.WORLD
    kwargs.setdefault("timeout", timedelta(seconds=DEFAULT_TIMEOUT_S))
    dist.init_process_group(backend=backend, **kwargs)
    logger.info("torch.distributed initialised: %s, rank %d of %d",
                dist.get_backend(), dist.get_rank(), dist.get_world_size())
    return dist.group.WORLD


def launch_mesh(mesh: str, device: str):
    """``(mesh, device)`` for a CLI run: ``--mesh single`` -> one device;
    ``--mesh auto`` under ``torchrun`` (``WORLD_SIZE`` above 1) initialises
    the default group unless the caller already has one, and a group of
    more than one rank gives a :class:`DataMesh` on this rank's device:
    ``cuda`` means ``cuda:LOCAL_RANK`` under NCCL; ``cuda:K`` puts every
    rank on card K, which NCCL refuses, so those ranks take gloo (CUDA
    tensors staged through the host) and one line says so; the CPU takes
    gloo.  A card that does not exist raises.  Otherwise one device: a
    named card ``cuda:K`` is card K; an unindexed ``cuda`` in a process
    that sees several cards raises here
    (:func:`~pydca_tpu_torch.parallel.mesh.reject_several_cards`; the CLIs
    start one rank a card first, :mod:`~pydca_tpu_torch.parallel.spawn`).
    """
    if mesh == "single":
        return None, device
    dev = torch.device(device)
    if not dist.is_initialized() and torchrun_world() > 1:
        backend = "gloo"
        if dev.type == "cuda":
            shared = dev.index is not None
            dev = _rank_card(dev)
            torch.cuda.set_device(dev)
            if shared:
                logger.warning("all %d ranks share card %s: gloo, since NCCL refuses two "
                               "ranks on one card", torchrun_world(), dev)
            else:
                backend = "nccl"
        init_distributed(backend)
    if dist.is_initialized() and dist.get_world_size() > 1:
        if dev.type == "cuda":
            dev = _rank_card(dev)
        return make_mesh(device=dev), dev
    reject_several_cards(device)
    return None, device


def _rank_card(dev: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:LOCAL_RANK``; ``cuda:K`` stays; either must exist."""
    index = int(os.environ.get("LOCAL_RANK", "0")) if dev.index is None else dev.index
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if index >= count:
        raise RuntimeError(f"rank's card cuda:{index} requested, but {count} card(s) are visible")
    return torch.device("cuda", index)


def _mesh_or_default(mesh: Optional[DataMesh], device) -> DataMesh:
    if mesh is not None:
        return mesh
    return make_mesh(device=device)


def sequence_weights_sharded(mesh: DataMesh, msa, seqid: float, q: int) -> torch.Tensor:
    """Weights of a whole alignment that every rank holds, the identity
    counts split over the ranks.

    ``msa``: the full (N, L) alignment (host array or tensor).  N is padded
    to a multiple of the world size with invalid rows, as
    ``pydca_tpu/parallel/fit.py::sequence_weights_sharded`` does; each rank
    counts its share of the kernel's tiles on the whole (padded) codes, and
    the (N,) int32 partial counts are summed over the ranks.  Returns the
    (N,) float32 weights on the mesh's device, the same on every rank (and
    equal to the one-device weights: the counts are exact).
    """
    codes = torch.as_tensor(np.asarray(msa) if not isinstance(msa, torch.Tensor) else msa)
    n, l = codes.shape
    n_pad = mesh.stripe_rows(n)[0]
    full = torch.zeros((n_pad, l), dtype=torch.int8, device=mesh.device)
    full[:n] = codes.to(mesh.device, torch.int8)
    valid = torch.arange(n_pad, device=mesh.device) < n
    thr = float(np.float32(float(seqid) * l))
    return stats.sharded_weights_full(mesh, full, valid, thr, q, torch.float32)[:n]


def _q_of(msa: torch.Tensor, biomolecule_q, mesh: DataMesh) -> int:
    """``biomolecule_q``, else the largest code over every rank's rows + 1."""
    if biomolecule_q:
        return int(biomolecule_q)
    top = torch.tensor([int(msa.max()) if msa.numel() else 0], device=msa.device)
    return int(mesh.max_(top, "q_allreduce").item()) + 1


def _local_weights(msa, weights, valid, seqid, q, mesh):
    """The stripe's weights: as given (in their float dtype), else computed
    over every rank's rows with the stripe's pads (``valid = False``) at 0."""
    if weights is not None:
        weights = torch.as_tensor(weights, device=msa.device)
        return weights if weights.is_floating_point() else weights.to(torch.float32)
    return stats.sequence_weights(msa, seqid, q, valid=valid, mesh=mesh)


def fit_plm_sharded(
    msa: torch.Tensor,
    *,
    biomolecule_q: Optional[int] = None,
    seqid: float = 0.8,
    lambda_h: Optional[float] = None,
    lambda_j: Optional[float] = None,
    max_iterations: int = 100,
    mesh: Optional[DataMesh] = None,
    weights: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    **fit_kwargs,
) -> LBFGSResult:
    """Sequence-sharded plmDCA fit over the mesh's ranks.

    ``msa``: this rank's (n, L) stripe of the rows, on the rank's device
    (:func:`~pydca_tpu_torch.parallel.mesh.shard_msa`, or
    :func:`~pydca_tpu_torch.parallel.data.weights_distributed`); every rank
    calls with its own.  ``weights``: the stripe's weights, used as they
    are; ``None`` computes them over every rank's rows, with ``valid``
    (default: every row) marking the pads, which get weight 0.  Remaining
    kwargs pass to :func:`pydca_tpu_torch.plm.fit_plm` (``seq_block``,
    ``checkpoint_path``, ...).  Every rank returns the same result.
    """
    from ..plm import fit_plm

    mesh = _mesh_or_default(mesh, msa.device)
    n, l = msa.shape
    q = _q_of(msa, biomolecule_q, mesh)
    lam_h = 0.2 * (l - 1) if lambda_h is None else float(lambda_h)
    lam_j = 0.2 * (l - 1) if lambda_j is None else float(lambda_j)
    w = _local_weights(msa, weights, valid, seqid, q, mesh)
    return fit_plm(msa, w, lam_h, lam_j, l, q, max_iterations=max_iterations, mesh=mesh,
                   **fit_kwargs)


def mfdca_sharded(
    msa: torch.Tensor,
    *,
    biomolecule_q: Optional[int] = None,
    pseudocount: float = 0.5,
    seqid: float = 0.8,
    mesh: Optional[DataMesh] = None,
    weights: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    return_couplings: bool = False,
    return_all: bool = False,
    timers=None,
):
    """Sequence-sharded mean-field DCA: FN and FN-APC over the mesh's ranks.

    The counterpart of ``pydca_tpu/parallel/fit.py::mfdca_sharded``.
    ``msa``, ``weights`` and ``valid`` are this rank's stripe, as for
    :func:`fit_plm_sharded` (given weights keep their dtype: float64
    weights give a float64 Gram and solve).  The Gram of the stripe's rows
    (the ``weighted_gram`` kernel on a card) is summed over the data axis.
    With a model axis of 1, C, ``-C^{-1}`` and the scores are computed on
    every rank (replicated).  Above 1, each rank cuts its row slab of C
    from the Gram (padded to whole sites on every rank), frees the Gram,
    and the solve runs on the slabs (blocked Cholesky above D = 4096,
    triangular inverse, reduce-scattered SYRK:
    :func:`pydca_tpu_torch.ops.linalg.spd_inverse`); each rank's FN rows
    are gathered over the model axis, and the APC is replicated.

    Returns ``(fn, fn_apc)`` of length L(L-1)/2 in pair order, the same on
    every rank; ``(fn, fn_apc, couplings)`` with ``return_couplings``
    (above 1 on the model axis: this rank's
    :class:`~pydca_tpu_torch.meanfield.CouplingRows`, its rows and their
    range); or a dict with the stripe's ``weights`` too with
    ``return_all``.  ``timers`` (a
    :class:`~pydca_tpu_torch.profiling.StageTimers`) times the stages
    ``weights``, ``gram``, ``corr``, and on a model axis ``cholesky``,
    ``tri_inv``, ``syrk`` and ``score``, each ended by a device synchronise.
    """
    from ..meanfield import _corr_rows, _gram_fi, _grid_solve, _mf_couplings, _real_rows

    mesh = _mesh_or_default(mesh, msa.device)
    l = msa.shape[1]
    q = _q_of(msa, biomolecule_q, mesh)
    with synced_stage(timers, "weights", msa.device):
        w = _local_weights(msa, weights, valid, seqid, q, mesh)
    with synced_stage(timers, "gram", msa.device):
        gram = stats.weighted_gram(msa, w, q, mesh=mesh)
    if mesh.model_size == 1:
        _, couplings, fn, fn_apc = _mf_couplings(gram, l, q, pseudocount)
    else:
        with synced_stage(timers, "corr", msa.device):
            c = _corr_rows(gram, _gram_fi(gram, l, q), l, q, pseudocount, mesh)
            del gram
        solve = _grid_solve(c, l, q, mesh, timers)
        del c
        fn, fn_apc = solve.fn, solve.fn_apc
        couplings = _real_rows(solve.slab, solve.full, l, q, mesh)
        del solve
    if return_all:
        return {"fn": fn, "fn_apc": fn_apc, "couplings": couplings, "weights": w}
    if return_couplings:
        return fn, fn_apc, couplings
    return fn, fn_apc

