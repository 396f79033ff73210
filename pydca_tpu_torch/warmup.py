"""Build ahead of time what the first run at given shapes would build.

Port of ``pydca_tpu/warmup.py``.  On the JAX side a new process pays the
XLA compile of every program for the MSA's shapes, and ``warmup`` fills the
persistent compilation cache.  Here the programs are PyTorch's own
kernels, already compiled, and the hand-written CUDA kernels, which build
with ``nvcc`` at first use into the cache directory of
:func:`pydca_tpu_torch.runtime.enable_compilation_cache`.  So a warmup
builds, through :func:`pydca_tpu_torch.ops._build.build`, every library
the run on a card would load: ``identity_counts`` (the weights of both
engines), for plmDCA ``plm_passes`` (the fused step's passes over the
logits) and, for mean-field, ``weighted_gram``.  The libraries do not
depend on the shapes or the options; (N, L, q) and the flags decide only
the route a plm run takes (fused or streamed, and the products'
precision: :func:`pydca_tpu_torch.plm.fit_seq_block`,
:func:`~pydca_tpu_torch.plm.resolve_precision`), which the warmup
reports, after checking the ``param_space`` name as the engine does
(:func:`~pydca_tpu_torch.plm._check_param_space`).

A warmup launches nothing on the card.  The CUDA context and the
cuBLAS/cuSOLVER handles are made by each process and die with it, so
making them in a warmup process would not shorten the next one
(``chip_smoke.py`` phase 17 times both parts of a process's start).

CLI: ``mfdca warmup <biomolecule> <msa>`` / ``plmdca warmup <biomolecule>
<msa> [--max_iterations ...]`` — reading the MSA pins the post-dedup
(N, L, q) of the real run, and builds the FASTA codec into the same cache.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import torch

from .ops import _build
from .plm import _check_param_space, fit_seq_block

logger = logging.getLogger(__name__)

__all__ = ["warmup_meanfield", "warmup_plm"]


def _build_all(names: Sequence[str], device) -> float:
    """Build ``names`` for ``device`` (one ``nvcc`` a source, all at once);
    seconds spent.  On the CPU there is nothing to build."""
    t0 = time.perf_counter()
    if torch.device(device).type == "cpu":
        logger.info("device cpu: the CPU runs no hand kernel, nothing to build")
        return time.perf_counter() - t0
    with ThreadPoolExecutor(len(names)) as pool:
        for fut in [pool.submit(_build.build, name) for name in names]:
            fut.result()
    return time.perf_counter() - t0


def warmup_meanfield(
    n: int,
    l: int,
    q: int,
    *,
    seqid: float = 0.8,
    pseudocount: float = 0.5,
    mesh=None,
    device="cuda",
) -> float:
    """Build the libraries an ``mfdca`` run at (N, L, q) on ``device``
    loads; returns seconds spent.  ``seqid``, ``pseudocount`` and ``mesh``
    change nothing that is built (every rank of a mesh loads the same
    libraries from the same cache); they are taken for the JAX
    signature."""
    dt = _build_all(("identity_counts", "weighted_gram"), device)
    logger.info(
        "mfDCA warmup (N=%d, L=%d, q=%d, seqid %s, pseudocount %s, mesh %s, device %s): "
        "%.1f s build into %s", n, l, q, seqid, pseudocount, mesh, device, dt, _build.BUILD_DIR,
    )
    return dt


def warmup_plm(
    n: int,
    l: int,
    q: int,
    *,
    seqid: float = 0.8,
    max_iterations: int = 100,
    seq_block: Optional[int] = None,
    chunk_size: Optional[int] = 50,
    m: int = 5,
    mm_bf16: Optional[bool] = None,
    param_space: str = "auto",
    mesh=None,
    device="cuda",
) -> float:
    """Build the libraries a ``plmdca`` run at (N, L, q) on ``device`` loads
    (``identity_counts``, ``plm_passes``); returns seconds spent.  Resolves the route as
    ``fit_plm`` does (``pydca_tpu/warmup.py:188-195``) and logs it: fused
    or streamed (``seq_block``, else the engine's own
    :func:`~pydca_tpu_torch.plm.fit_seq_block` on one card) and the
    products' operands (``mm_bf16``, ``None``: float32); checks
    ``param_space`` with the engine's warning for ``w2``; records
    ``chunk_size``, which the fit's chunking takes and the build does not
    (``m`` is taken for the JAX signature)."""
    _check_param_space(param_space)
    block = seq_block if seq_block is not None else fit_seq_block(n, l, q)
    route = "fused" if block is None else f"streamed over blocks of {block}"
    dt = _build_all(("identity_counts", "plm_passes"), device)
    logger.info(
        "plmDCA warmup (N=%d, L=%d, q=%d, seqid %s, %d iterations in chunks of %s, %s, "
        "%s products, mesh %s, device %s): %.1f s build into %s", n, l, q, seqid,
        max_iterations, chunk_size, route, "bfloat16" if mm_bf16 else "float32", mesh, device,
        dt, _build.BUILD_DIR,
    )
    return dt
