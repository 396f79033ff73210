"""Process-level runtime knobs for the CLI entry points.

Port of ``pydca_tpu/runtime.py``.  What a new process pays on the JAX side
is the XLA compile, which a persistent compilation cache removes; here it
is the ``nvcc`` build of the CUDA kernels (and the ``g++`` build of the
FASTA codec), which :mod:`pydca_tpu_torch.ops._build` caches as libraries
named by a hash of their sources and flags.  This module chooses the
directory those libraries go to and are found in: an installed package may
not be able to write into its own directory.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

from .ops import _build

logger = logging.getLogger(__name__)

__all__ = ["CACHE_ENV", "enable_compilation_cache"]

CACHE_ENV = "PYDCA_TPU_CACHE_DIR"


def enable_compilation_cache(cache_dir: Optional[str] = None) -> Path:
    """Point the kernel build cache at a directory; returns it.

    The choice is ``cache_dir`` when given, else ``$PYDCA_TPU_CACHE_DIR``
    (its ``torch_build/`` sub-directory), else the in-package
    ``pydca_tpu_torch/_build/``.  An empty ``PYDCA_TPU_CACHE_DIR`` keeps the
    default, as on the JAX side.  A directory that cannot be created is
    logged, not raised, and the cache stays where it was.  Safe to call
    more than once.
    """
    env = os.environ.get(CACHE_ENV)
    if cache_dir:
        path = Path(cache_dir)
    elif env:
        path = Path(env) / "torch_build"
    else:
        path = _build.DEFAULT_BUILD_DIR
    if path != _build.DEFAULT_BUILD_DIR:
        try:
            path.mkdir(parents=True, exist_ok=True)
        except OSError as exc:
            logger.warning("could not create the kernel build cache %s (%s); "
                           "keeping %s", path, exc, _build.BUILD_DIR)
            return _build.BUILD_DIR
    _build.BUILD_DIR = path
    return path
