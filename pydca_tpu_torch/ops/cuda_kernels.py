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

import contextlib
import ctypes
import functools
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


def _check_code_range(codes: torch.Tensor, q: int) -> None:
    # A one-hot ignores an out-of-range code, a byte compare counts it: one
    # reduction and one device->host read per call keep the two versions in
    # agreement.
    if codes.numel():
        lo, hi = torch.stack(torch.aminmax(codes)).tolist()
        if lo < 0 or hi >= q:
            raise ValueError(f"codes must lie in [0, {q}); found [{lo}, {hi}]")


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
    _check_code_range(codes, q)
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


_GRAM_TILE = 128  # output tile edge of csrc/weighted_gram.cu
_GRAM_STAGE = 64  # sequences per stage; split-N chunks are whole stages
_GRAM_WS_FLOOR = 64 << 20  # the workspace cap is max(output bytes, this)


def _bf16_split(w: torch.Tensor) -> torch.Tensor:
    """(3, N) bfloat16 pieces with ``w == w1 + w2 + w3`` exactly in float32.

    ``w1 = bf16(w)``, ``w2 = bf16(w - w1)``, ``w3 = bf16(w - w1 - w2)``, each
    difference taken in float32: three 8-bit significands cover float32's
    24, and bfloat16 has float32's exponent range.  The kernel's first pass
    does the same arithmetic (``split_weights``); this is its statement for
    the tests.
    """
    w1 = w.to(torch.bfloat16)
    r1 = w - w1.float()
    w2 = r1.to(torch.bfloat16)
    return torch.stack((w1, w2, (r1 - w2.float()).to(torch.bfloat16)))


@functools.lru_cache(maxsize=256)
def _gram_plan(n: int, k: int, sms: int, itemsize: int = 4):
    """``(splits, chunk, workspace_bytes)`` for the Gram kernel.

    One block per upper-triangle 128 x 128 tile and chunk of ``chunk``
    sequences (whole 64-sequence stages; ``splits`` chunks, none empty).
    Both tile kernels hold one block per SM, so while the tiles are fewer
    than the SMs, N is cut into about ``ceil(sms / tiles)`` chunks, one wave
    of blocks: at most one chunk per stage, and fewer when the workspace
    (one partial tile per tile and chunk) would pass max(output bytes,
    64 MiB).  ``scripts/torch_gram_splits.py`` times the other counts.
    """
    side = -(-k // _GRAM_TILE)
    tiles = side * (side + 1) // 2
    stages = max(1, -(-n // _GRAM_STAGE))
    tile_bytes = _GRAM_TILE * _GRAM_TILE * itemsize
    cap = max(k * k * itemsize, _GRAM_WS_FLOOR)
    want = max(1, min(stages, -(-sms // tiles), cap // (tiles * tile_bytes)))
    per = -(-stages // want)
    splits = -(-stages // per)  # no empty chunk
    return splits, per * _GRAM_STAGE, splits * tiles * tile_bytes if splits > 1 else 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def weighted_gram(codes: torch.Tensor, weights: torch.Tensor, q: int) -> torch.Tensor:
    """``G[(i,a),(j,b)] = sum_n w_n [codes[n,i] == a] [codes[n,j] == b]``.

    ``codes``: (N, L) integer alignment with states in [0, q); ``weights``:
    (N,) float32 or float64 on the same device.  Returns the (L*q, L*q)
    Gram in the weights' dtype, unnormalised like the TPU kernel
    (``pallas_kernels.py:176``); the caller divides by Meff.

    On a CPU tensor this is :func:`weighted_gram_reference`; on a CUDA
    tensor it launches ``csrc/weighted_gram.cu`` (float32 on the tensor
    cores, float64 on the CUDA cores) or raises.
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
        _check_code_range(codes, q)
        return weighted_gram_reference(codes, weights, q)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")

    if codes.dtype != torch.int8:  # the cast must not wrap an out-of-range code
        _check_code_range(codes, q)
        codes = codes.to(torch.int8)
    k = l * q
    dev = codes.device
    itemsize = weights.element_size()
    splits, chunk, ws_bytes = _gram_plan(n, k, _sm_count(dev.index), itemsize)
    # one scratch allocation: the transposed codes (L, npad) with npad a
    # whole number of stages; for float32 the bf16 weight pieces (3 x 2
    # bytes a sequence); the split-N workspace
    npad = _round_up(max(n, 1), _GRAM_STAGE)
    wpk_off = _round_up(l * npad, 256)
    ws_off = wpk_off + (_round_up(6 * npad, 256) if itemsize == 4 else 0)
    scratch = torch.empty(ws_off + ws_bytes, dtype=torch.uint8, device=dev)
    out = torch.empty((k, k), dtype=weights.dtype, device=dev)
    c8, w = codes.contiguous(), weights.contiguous()
    lib = _weighted_gram_lib()
    launch = lib.weighted_gram_f32 if itemsize == 4 else lib.weighted_gram_f64
    base = scratch.data_ptr()
    # the launch goes to the current device (entering a context costs more
    # than the check at small K)
    same = dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if same else torch.cuda.device(dev):
        err = launch(
            c8.data_ptr(), w.data_ptr(), out.data_ptr(), base,
            base + wpk_off if itemsize == 4 else None,
            base + ws_off if splits > 1 else None,
            n, npad, l, q, splits, chunk, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err > 0:
        raise RuntimeError(f"weighted_gram launch failed: CUDA error {err}")
    if err < 0:  # the first pass found codes outside [0, q): say which
        _check_code_range(codes, q)
        raise ValueError(f"codes must lie in [0, {q})")
    weighted_gram.launches += 1
    return out


weighted_gram.launches = 0


@functools.lru_cache(maxsize=None)
def _weighted_gram_lib() -> ctypes.CDLL:
    lib = _build.load("weighted_gram")
    for fn in (lib.weighted_gram_f32, lib.weighted_gram_f64):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib
