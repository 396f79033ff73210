"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

- :func:`identity_counts` — the O(N^2 L) all-pairs identity count behind
  sequence reweighting; replaces the TPU kernel
  ``pydca_tpu/ops/pallas_kernels.py::identity_counts``.  The kernel is
  ``csrc/identity_counts.cu`` (see its header for the design).
- :func:`weighted_gram` — the weighted one-hot co-occurrence matrix
  ``X^T diag(w) X`` behind the mean-field frequencies and correlation
  matrix; replaces ``pydca_tpu/ops/pallas_kernels.py::weighted_gram``.  The
  kernel is ``csrc/weighted_gram.cu``.

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

__all__ = [
    "identity_counts",
    "identity_counts_reference",
    "weighted_gram",
    "weighted_gram_reference",
]

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


def weighted_gram_reference(
    codes: torch.Tensor, weights: torch.Tensor, q: int
) -> torch.Tensor:
    """Plain version: ``x.T @ (x * w[:, None])`` on the one-hot ``x`` in the
    weights' dtype; (K, K) with K = L*q, unnormalised.  Products are ``w``
    or 0 exactly; :func:`~pydca_tpu_torch.device.set_precision` keeps TF32
    off, so the sums run in full float32 (or float64)."""
    n, l = codes.shape
    x = torch.nn.functional.one_hot(codes.long(), q).to(weights.dtype)
    x = x.reshape(n, l * q)
    return x.T @ (x * weights[:, None])


def weighted_gram(codes: torch.Tensor, weights: torch.Tensor, q: int) -> torch.Tensor:
    """``G[(i,a),(j,b)] = sum_n w_n [codes[n,i] == a] [codes[n,j] == b]``.

    ``codes``: (N, L) integer alignment with states in [0, q); ``weights``:
    (N,) float32 or float64 on the same device.  Returns the (L*q, L*q)
    Gram in the weights' dtype, unnormalised like the TPU kernel
    (``pallas_kernels.py:176``); the caller divides by Meff.

    On a CPU tensor this is :func:`weighted_gram_reference`; on a CUDA
    tensor it launches ``csrc/weighted_gram.cu`` (float32 or float64) or
    raises.
    """
    _check_codes(codes, q)
    n, l = codes.shape
    if weights.shape != (n,) or weights.device != codes.device:
        raise ValueError(
            f"weights must be ({n},) on {codes.device}, got "
            f"{tuple(weights.shape)} on {weights.device}"
        )
    if weights.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"weights must be float32 or float64, got {weights.dtype}")
    if codes.device.type == "cpu":
        return weighted_gram_reference(codes, weights, q)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")

    k = l * q
    out = torch.empty((k, k), dtype=weights.dtype, device=codes.device)
    lib = _weighted_gram_lib()
    launch = lib.weighted_gram_f32 if weights.dtype == torch.float32 else lib.weighted_gram_f64
    # the range check above makes this cast lossless; done once per call
    c8 = codes.to(torch.int8).contiguous()
    w = weights.contiguous()
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = launch(c8.data_ptr(), w.data_ptr(), out.data_ptr(), n, l, q, stream)
    if err != 0:
        raise RuntimeError(f"weighted_gram launch failed: CUDA error {err}")
    weighted_gram.launches += 1
    return out


weighted_gram.launches = 0


def _weighted_gram_lib() -> ctypes.CDLL:
    lib = _build.load("weighted_gram")
    for fn in (lib.weighted_gram_f32, lib.weighted_gram_f64):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib
