"""ctypes wrapper around the native FASTA codec (C++, built at first use).

Port of ``pydca_tpu/native/fastacodec.py``.  ``fastacodec.cpp`` compiles
with the system ``g++`` into the kernel build cache
(:data:`pydca_tpu_torch.ops._build.BUILD_DIR`), named by a hash of the
source and the flags as the CUDA libraries are; nothing is built when the
module is imported.  Without a compiler :func:`available` is False and
:func:`pydca_tpu_torch.io.fasta.read_msa` reads with its Python path.
"""

from __future__ import annotations

import ctypes
import logging
import shutil
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..ops import _build

logger = logging.getLogger(__name__)

__all__ = ["GXX_FLAGS", "available", "library_path", "read_and_encode"]

SRC = Path(__file__).resolve().parent / "fastacodec.cpp"
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_LIB = None
_LOCK = threading.Lock()
_BUILD_FAILED = False


def library_path() -> Path:
    """Where the codec's library lives for this source and these flags."""
    return _build.hashed_path("fastacodec", [SRC], GXX_FLAGS)


def _build_lib() -> Optional[Path]:
    """Compile the codec unless its hashed library exists; ``None`` when
    there is no ``g++`` or the compile fails (logged)."""
    global _BUILD_FAILED
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    try:
        if gxx is None:
            raise RuntimeError("g++ not found on PATH")
        return _build.compile_library(out, gxx, GXX_FLAGS, SRC, "the FASTA codec")
    except (OSError, RuntimeError) as exc:
        logger.info("native FASTA codec unavailable (%s)", exc)
        _BUILD_FAILED = True
        return None


def _get_lib():
    global _LIB
    with _LOCK:
        if _LIB is not None or _BUILD_FAILED:
            return _LIB
        so = _build_lib()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        lib.fasta_encode.argtypes = (
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int8),
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int8)),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64),
        )
        lib.fasta_encode.restype = ctypes.c_int
        lib.fasta_free.argtypes = (ctypes.c_void_p,)
        lib.fasta_free.restype = None
        _LIB = lib
        return _LIB


def available() -> bool:
    """Whether the codec is built (building it on the first call)."""
    return _get_lib() is not None


_ERRORS = {
    -1: "cannot open file",
    -2: "no sequences found",
    -3: "alignment sequences have differing lengths",
    -4: "sequence data before first '>' header",
    -5: "allocation failure",
}


def read_and_encode(
    file_name: str, alphabet, dedup: bool = True
) -> Tuple[np.ndarray, List[str]]:
    """Parse + encode + dedup a FASTA file natively.

    Returns an (N, L) int8 array (0-based states, gap = alphabet.gap_state)
    and the ids of the kept records.  Raises on malformed input with the same
    error classes as the Python path.  Each call adds one to
    ``read_and_encode.reads``.
    """
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    table = alphabet._encode_table.astype(np.int8)
    table_c = table.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
    data_p = ctypes.POINTER(ctypes.c_int8)()
    n = ctypes.c_int32()
    l = ctypes.c_int32()
    ids_p = ctypes.c_char_p()
    ids_len = ctypes.c_int64()
    read_and_encode.reads += 1
    rc = lib.fasta_encode(
        file_name.encode(),
        table_c,
        1 if dedup else 0,
        ctypes.byref(data_p),
        ctypes.byref(n),
        ctypes.byref(l),
        ctypes.byref(ids_p),
        ctypes.byref(ids_len),
    )
    if rc != 0:
        from ..io.fasta import FastaError

        raise FastaError(
            f"{_ERRORS.get(rc, f'error {rc}')} in {file_name}"
        )
    try:
        data = np.ctypeslib.as_array(data_p, shape=(int(n.value), int(l.value))).copy()
        ids_blob = ctypes.string_at(ids_p, ids_len.value).decode(
            "utf-8", errors="replace"
        )
    finally:
        lib.fasta_free(ctypes.cast(data_p, ctypes.c_void_p))
        lib.fasta_free(ctypes.cast(ids_p, ctypes.c_void_p))
    ids = ids_blob.split("\n") if ids_blob else []
    return data, ids


read_and_encode.reads = 0
