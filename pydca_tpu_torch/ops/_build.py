"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` compiles on first use into a shared library with a
plain ``extern "C"`` interface, loaded with :mod:`ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/lib<name>_<hash>.so csrc/<name>.cu

The library lands in :data:`BUILD_DIR`, named by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so a stale library is never
loaded.  :data:`BUILD_DIR` is ``pydca_tpu_torch/_build/`` (git-ignored)
unless :func:`pydca_tpu_torch.runtime.enable_compilation_cache` moves it;
the host codec (:mod:`pydca_tpu_torch.native.fastacodec`) builds there too,
through :func:`compile_library`.
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

__all__ = [
    "DEFAULT_BUILD_DIR", "NVCC_FLAGS", "build", "compile_library", "find_nvcc",
    "hashed_path", "library_path", "load",
]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
DEFAULT_BUILD_DIR = _PKG / "_build"
BUILD_DIR = DEFAULT_BUILD_DIR  # where libraries are put and found (runtime.py moves it)

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


def hashed_path(name: str, sources, flags) -> Path:
    """``BUILD_DIR/lib<name>_<hash>.so`` for the first of ``sources``, the
    names and bytes of the others and the ``flags``."""
    h = hashlib.sha256(Path(sources[0]).read_bytes())
    for extra in sources[1:]:
        extra = Path(extra)
        h.update(extra.name.encode() + b"\0" + extra.read_bytes())
    h.update("\0".join(flags).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives for this source, the
    shared headers ``csrc/*.cuh`` and the flags."""
    return hashed_path(name, [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))], NVCC_FLAGS)


def compile_library(out: Path, compiler: str, flags, source: Path, what: str) -> Path:
    """``compiler *flags -o <tmp> source``, then rename the result to
    ``out``: a concurrent or interrupted build never leaves a half-written
    library under the final name.  A failed compile raises with its
    output."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = [compiler, *flags, "-o", tmp, str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(compiler)} failed for {what} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


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
    return compile_library(out, nvcc, NVCC_FLAGS, CSRC / f"{name}.cu", repr(name))


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib
