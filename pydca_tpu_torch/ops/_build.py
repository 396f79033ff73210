"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` compiles on first use into a shared library with a
plain ``extern "C"`` interface, loaded with :mod:`ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/lib<name>_<hash>.so csrc/<name>.cu

The library lands in ``pydca_tpu_torch/_build/`` (git-ignored), named by a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
a stale library is never loaded.
When ``nvcc`` is missing this raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

__all__ = ["NVCC_FLAGS", "build", "find_nvcc", "library_path", "load"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> Optional[str]:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.access(cand, os.X_OK):
                return cand
    return None


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives for this source, the
    shared headers ``csrc/*.cuh`` and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library already exists."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build the CUDA kernel {name!r}: nvcc not found on PATH, "
            "under $CUDA_HOME/bin or /usr/local/cuda/bin"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name!r} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib
