"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

- :func:`identity_counts` — the O(N^2 L) all-pairs identity count behind
  sequence reweighting; replaces the TPU kernel
  ``pydca_tpu/ops/pallas_kernels.py::identity_counts``.  The kernel is
  ``csrc/identity_counts.cu`` (see its header for the design).

A wrapper takes the plain version only because its tensor lies on the CPU;
for a CUDA tensor it launches the kernel or raises.  Each wrapper counts
its kernel launches in a plain integer attribute (``.launches``) so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _build

__all__ = ["identity_counts", "identity_counts_reference"]

_INT_DTYPES = (torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64)


def _thr_f32(thr: float) -> float:
    """The threshold as the float32 value the JAX paths compare against
    (``jnp.float32(thr)``, ``pydca_tpu/stats.py:166,181``)."""
    return float(np.float32(thr))


def identity_counts_reference(
    codes: torch.Tensor,
    thr: float,
    q: int,
    valid: Optional[torch.Tensor] = None,
    block: int = 1024,
) -> torch.Tensor:
    """Plain blocked version: ``#{j : valid[j], matches(i, j) > thr}``.

    Builds the float32 one-hot ``(N, L*q)`` once and, per block of rows,
    multiplies ``(B, Lq) @ (Lq, N)``: products are 0/1 and sums are at
    most L, so the counts are exact for L < 2^24 (even under TF32, whose
    inputs hold 0 and 1 exactly).  Returns (N,) int32 on ``codes.device``.
    """
    n, l = codes.shape
    thr32 = _thr_f32(thr)
    x = torch.nn.functional.one_hot(codes.long(), q).to(torch.float32)
    x = x.reshape(n, l * q)
    vmask = None if valid is None else valid.to(torch.bool)[None, :]
    out = torch.empty(n, dtype=torch.int32, device=codes.device)
    for r0 in range(0, n, block):
        ind = (x[r0 : r0 + block] @ x.T) > thr32  # (B, N)
        if vmask is not None:
            ind &= vmask
        out[r0 : r0 + block] = ind.sum(dim=1, dtype=torch.int32)
    return out


def _check_codes(codes: torch.Tensor, q: int) -> None:
    if codes.dim() != 2:
        raise ValueError(f"codes must be (N, L), got shape {tuple(codes.shape)}")
    if codes.dtype not in _INT_DTYPES:
        raise TypeError(f"codes must be an integer tensor, got {codes.dtype}")
    if not 0 < q <= 127:
        raise ValueError(f"q must lie in [1, 127], got {q}")
    if codes.numel():
        # A one-hot ignores an out-of-range code, a byte compare counts it:
        # one reduction per call keeps the two versions in agreement.
        lo, hi = torch.aminmax(codes)
        if int(lo) < 0 or int(hi) >= q:
            raise ValueError(
                f"codes must lie in [0, {q}); found [{int(lo)}, {int(hi)}]"
            )


def identity_counts(
    codes: torch.Tensor,
    thr: float,
    q: int,
    valid: Optional[torch.Tensor] = None,
    block: int = 1024,
) -> torch.Tensor:
    """#{j : valid[j] and identity(i, j) > thr} for every row i; (N,) int32.

    ``codes``: (N, L) integer alignment with states in [0, q).  ``thr`` is
    rounded to float32 and compared strictly, in float32, as the TPU
    kernel does (``pallas_kernels.py:129``).  ``valid``: optional (N,)
    bool mask; rows with ``valid = False`` are no one's neighbour.

    On a CPU tensor this is :func:`identity_counts_reference` (``block``
    is its row block); on a CUDA tensor it launches
    ``csrc/identity_counts.cu`` or raises.
    """
    _check_codes(codes, q)
    n, l = codes.shape
    if valid is not None and (valid.shape != (n,) or valid.device != codes.device):
        raise ValueError(
            f"valid must be ({n},) on {codes.device}, got "
            f"{tuple(valid.shape)} on {valid.device}"
        )
    if codes.device.type == "cpu":
        return identity_counts_reference(codes, thr, q, valid=valid, block=block)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")

    lib = _identity_counts_lib()
    if n > lib.identity_counts_max_rows():
        raise ValueError(
            f"N = {n} exceeds the kernel's grid limit "
            f"{lib.identity_counts_max_rows()}"
        )
    # the range check above makes this cast lossless; done once per call
    c8 = codes.to(torch.int8).contiguous()
    v8 = None
    if valid is not None:
        v8 = valid.to(torch.bool).contiguous()
    out = torch.zeros(n, dtype=torch.int32, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = lib.identity_counts_launch(
            c8.data_ptr(),
            None if v8 is None else v8.data_ptr(),
            out.data_ptr(),
            n,
            l,
            _thr_f32(thr),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"identity_counts launch failed: CUDA error {err}")
    identity_counts.launches += 1
    return out


identity_counts.launches = 0


def _identity_counts_lib() -> ctypes.CDLL:
    lib = _build.load("identity_counts")
    fn = lib.identity_counts_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.identity_counts_max_rows.argtypes = []
    lib.identity_counts_max_rows.restype = ctypes.c_int
    return lib
