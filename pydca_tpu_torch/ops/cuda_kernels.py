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
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

__all__ = [
    "identity_counts",
    "identity_counts_reference",
    "identity_tile_share",
    "weighted_gram",
    "weighted_gram_reference",
]

_INT_DTYPES = (torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64)


def _thr_f32(thr: float) -> float:
    """The threshold as the float32 value the JAX paths compare against
    (``jnp.float32(thr)``, ``pydca_tpu/stats.py:166,181``)."""
    return float(np.float32(thr))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def identity_counts_reference(
    codes: torch.Tensor,
    thr: float,
    q: int,
    valid: Optional[torch.Tensor] = None,
    block: int = 1024,
    tiles: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Plain blocked version: ``#{j : valid[j], matches(i, j) > thr}``.

    Builds the float32 one-hot ``(N, L*q)`` once and, per block of rows,
    multiplies ``(B, Lq) @ (Lq, N)``: products are 0/1 and sums are at
    most L, so the counts are exact for L < 2^24 (even under TF32, whose
    inputs hold 0 and 1 exactly).  Returns (N,) int32 on ``codes.device``.

    ``tiles = (t0, t1)``: only what the kernel's tiles ``[t0, t1)`` add
    (:func:`_identity_tile_partial`); ``block`` is then unused.
    """
    n, l = codes.shape
    thr32 = _thr_f32(thr)
    x = torch.nn.functional.one_hot(codes.long(), q).to(torch.float32)
    x = x.reshape(n, l * q)
    if tiles is not None:
        return _identity_tile_partial(x, thr32, valid, n, tiles)
    vmask = None if valid is None else valid.to(torch.bool)[None, :]
    out = torch.empty(n, dtype=torch.int32, device=codes.device)
    for r0 in range(0, n, block):
        ind = (x[r0 : r0 + block] @ x.T) > thr32  # (B, N)
        if vmask is not None:
            ind &= vmask
        out[r0 : r0 + block] = ind.sum(dim=1, dtype=torch.int32)
    return out


def _identity_tile_partial(x, thr32, valid, n: int, tiles) -> torch.Tensor:
    """The partial counts of the kernel's upper-triangle tiles ``[t0, t1)``
    (``_identity_tile_of`` order) on the one-hot ``x``.

    A tile (I, J), I < J, adds ``[matches(i, j) > thr] valid[j]`` to each
    row i of row tile I and, by symmetry, ``[matches(i, j) > thr]
    valid[i]`` to each row j of row tile J; a diagonal tile (I, I) adds
    the first term alone, over its ordered pairs.  The tiles of one column
    J in the range have consecutive I, so each column is one
    ``(rows of I_a..I_b, Lq) @ (Lq, rows of J)`` product.
    """
    t0, t1 = (int(t) for t in tiles)
    side = -(-n // _IC_TILE)
    if not 0 <= t0 <= t1 <= side * (side + 1) // 2:
        raise ValueError(f"tile range [{t0}, {t1}) outside [0, {side * (side + 1) // 2})")
    vmask = (torch.ones(n, dtype=torch.bool, device=x.device) if valid is None
             else valid.to(torch.bool))
    out = torch.zeros(n, dtype=torch.int32, device=x.device)
    t = t0
    while t < t1:
        ia, tj = _identity_tile_of(t)
        ib = min(tj, ia + (t1 - t) - 1)  # last row tile of this column in range
        t += ib - ia + 1
        a0, a1 = ia * _IC_TILE, min((ib + 1) * _IC_TILE, n)
        b0, b1 = tj * _IC_TILE, min((tj + 1) * _IC_TILE, n)
        ind = (x[a0:a1] @ x[b0:b1].T) > thr32  # (rows of I_a..I_b, rows of J)
        out[a0:a1] += (ind & vmask[None, b0:b1]).sum(dim=1, dtype=torch.int32)
        off = min(a1, b0) - a0  # rows above the diagonal tile
        if off > 0:
            out[b0:b1] += (ind[:off] & vmask[a0 : a0 + off, None]).sum(dim=0, dtype=torch.int32)
    return out


def identity_tile_share(n: int, rank: int, world: int) -> Tuple[int, int]:
    """Rank ``rank``'s share ``(t0, t1)`` of the identity-count kernel's
    T(T+1)/2 upper-triangle tiles (T = ceil(N / 128)): contiguous ranges of
    sizes that differ by at most one, in rank order.  Every tile costs the
    same (a diagonal one skips its column sums), so equal counts balance
    the ranks."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    side = -(-n // _IC_TILE)
    total = side * (side + 1) // 2
    return total * rank // world, total * (rank + 1) // world


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


# twins of csrc/identity_counts.cu's constants; the scratch size comes from
# the library (identity_counts_scratch_bytes), the tests hold these to it
_IC_TILE = 128  # tile edge (rows of A and of B)
_IC_KB = 128  # positions per stage: L is padded to a multiple
_IC_PAD = 0x7F  # the code of padding: equals no state (q <= 127)
_IC_SHIFT = 14  # a match adds 0x80 * 0x80 = 2^14 to the s32 accumulator
_IC_MAX_LEN = (1 << 17) - 1  # so that L << 14 fits in s32


def _identity_plan(n: int, l: int):
    """``(npad, lpad, tiles)`` of the identity-count kernel, the tests'
    statement of its plan: the padded codes are (npad, lpad), npad = 128 T
    with T = ceil(N / 128) row tiles, lpad = L rounded up to 128, and the
    1-D grid has one block per upper-triangle tile, T(T+1)/2."""
    side = -(-n // _IC_TILE)
    return side * _IC_TILE, _round_up(l, _IC_KB), side * (side + 1) // 2


def _identity_min_acc(thr: float) -> int:
    """The kernel's form of the float32 threshold: the least accumulator
    that passes.  A count m <= L < 2^17 is exact in float32, so
    ``float32(m) > thr32`` exactly when m >= floor(thr32) + 1, and the
    accumulator holds m << 14: 0 when every count passes (thr32 < 0),
    0xFFFFFFFF when none can (NaN, or thr32 >= the longest L)."""
    t = _thr_f32(thr)
    if math.isnan(t) or t >= _IC_MAX_LEN:
        return 0xFFFFFFFF
    if t < 0:
        return 0
    return (math.floor(t) + 1) << _IC_SHIFT


def _identity_tile_of(t: int):
    """``(I, J)``, I <= J, of block ``t = J(J+1)/2 + I``: the kernel's
    ``tile_of``."""
    j = (math.isqrt(8 * t + 1) - 1) // 2
    return t - j * (j + 1) // 2, j


def identity_counts(
    codes: torch.Tensor,
    thr: float,
    q: int,
    valid: Optional[torch.Tensor] = None,
    block: int = 1024,
    tiles: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """#{j : valid[j] and identity(i, j) > thr} for every row i; (N,) int32.

    ``codes``: (N, L) integer alignment with states in [0, q).  ``thr`` is
    rounded to float32 and compared strictly, in float32, as the TPU
    kernel does (``pallas_kernels.py:129``).  ``valid``: optional (N,)
    bool mask; rows with ``valid = False`` are no one's neighbour.
    ``tiles = (t0, t1)``: only the partial counts that the kernel's
    upper-triangle tiles ``[t0, t1)`` add (:func:`identity_tile_share`
    splits the list over ranks; the partials of a split sum to the full
    counts exactly).

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
        return identity_counts_reference(codes, thr, q, valid=valid, block=block, tiles=tiles)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")

    lib = _identity_counts_lib()
    max_n = lib.identity_counts_max_rows()
    if n > max_n or l > _IC_MAX_LEN:
        raise ValueError(
            f"(N, L) = ({n}, {l}) exceeds the kernel's limits "
            f"N <= {max_n}, L <= {_IC_MAX_LEN}"
        )
    total = _identity_plan(n, l)[2]
    t0, t1 = (0, total) if tiles is None else (int(t) for t in tiles)
    if not 0 <= t0 <= t1 <= total:
        raise ValueError(f"tile range [{t0}, {t1}) outside [0, {total})")
    # the range check above makes this cast lossless; done once per call
    c8 = codes.to(torch.int8).contiguous()
    v8 = None
    if valid is not None:
        v8 = valid.to(torch.bool).contiguous()
    padded = torch.empty(
        lib.identity_counts_scratch_bytes(n, l), dtype=torch.uint8, device=codes.device
    )
    out = torch.zeros(n, dtype=torch.int32, device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = lib.identity_counts_launch(
            c8.data_ptr(),
            None if v8 is None else v8.data_ptr(),
            out.data_ptr(),
            padded.data_ptr(),
            n,
            l,
            q,
            _identity_min_acc(thr),
            t0,
            t1,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"identity_counts launch failed: CUDA error {err}")
    identity_counts.launches += 1
    return out


identity_counts.launches = 0


@functools.lru_cache(maxsize=None)
def _identity_counts_lib() -> ctypes.CDLL:
    lib = _build.load("identity_counts")
    fn = lib.identity_counts_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.identity_counts_max_rows.argtypes = []
    lib.identity_counts_max_rows.restype = ctypes.c_int
    lib.identity_counts_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.identity_counts_scratch_bytes.restype = ctypes.c_longlong
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
