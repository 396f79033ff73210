"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

- :func:`identity_counts` — the O(N^2 L) all-pairs identity count behind
  sequence reweighting; replaces the TPU kernel
  ``pydca_tpu/ops/pallas_kernels.py::identity_counts``.  The kernel is
  ``csrc/identity_counts.cu`` (see its header for the design).
- :func:`weighted_gram` — the weighted one-hot co-occurrence matrix
  ``X^T diag(w) X`` behind the mean-field frequencies and correlation
  matrix; replaces ``pydca_tpu/ops/pallas_kernels.py::weighted_gram``.  The
  kernel is ``csrc/weighted_gram.cu``.
- :func:`plm_trial` and :func:`plm_update_grad` — the elementwise passes of
  the fused plmDCA L-BFGS step over the ``(N, q, L)`` logits: one line-search
  trial's objective and slope, and the step's update with the gradient's
  softmax cotangent.  They replace no TPU kernel (XLA fuses the same
  composition there); the kernels are ``csrc/plm_passes.cu``.
- :func:`lbfgs_coeffs`, :func:`lbfgs_history` and :func:`lbfgs_finish` —
  the fused step's L-BFGS algebra beside its history on the card: the
  direction's coefficients, the history's new rows with its Gram's border,
  and the direction.  They replace no TPU kernel (the JAX package's jitted
  step runs the same algebra on the device); the kernels are in the same
  source.  They open no span: their callers' spans (``plm/direction``,
  ``plm/history``) hold them.

A wrapper takes the plain version only because its tensor lies on the CPU;
for a CUDA tensor it launches the kernel or raises.  Each wrapper counts
its kernel launches in a plain integer attribute (``.launches``) so a run
can show that its main path went through the kernel, and opens the span
``pydca/<wrapper>`` (:func:`~pydca_tpu_torch.profiling.span`) around the
launch alone, or around the plain version on the CPU, so that a trace
gives the kernel's device time as its own.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..profiling import span
from . import _build

__all__ = [
    "identity_counts",
    "identity_counts_reference",
    "identity_tile_share",
    "lbfgs_coeffs",
    "lbfgs_coeffs_reference",
    "lbfgs_finish",
    "lbfgs_history",
    "lbfgs_history_reference",
    "plm_trial",
    "plm_trial_reference",
    "plm_update_grad",
    "plm_update_grad_reference",
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
        with span("identity_counts"):
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
    with torch.cuda.device(codes.device), span("identity_counts"):
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


def _launch_on(dev: torch.device):
    """A context that makes ``dev`` current for a launch: none when it
    already is (entering a device context costs more than the check)."""
    same = dev.index == torch.cuda.current_device()
    return contextlib.nullcontext() if same else torch.cuda.device(dev)


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
        with span("weighted_gram"):
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
    with _launch_on(dev), span("weighted_gram"):
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


# ------------------------------------------- the fused plmDCA step's passes
_PLM_QS = (5, 21)  # the alphabets' q: csrc/plm_passes.cu is built for these


def plm_trial_reference(logits, codes, weights, picked, u, dh, alpha: float) -> torch.Tensor:
    """Plain version of :func:`plm_trial`: ``u' = u + dh`` and its picked
    values, then the data term ``phi(alpha)`` and its derivative along the
    direction, exploiting ``logits(alpha) = logits + alpha*u'``: softmax
    statistics and the ``ct . u'`` contraction in one composition."""
    from ..plm import _pick_mask, _picked  # the plm module imports this one

    u = u + dh.T[None]
    upicked = _picked(u, _pick_mask(codes, logits.shape[1]))
    t = logits + alpha * u
    mx = t.amax(dim=1)
    e = torch.exp(t - mx[:, None, :])
    se = e.sum(dim=1)  # (N, L)
    lse = mx + torch.log(se)
    pk = picked + alpha * upicked
    nll = (weights[:, None] * (lse - pk)).sum()
    su = (e * u).sum(dim=1) / se  # E_softmax[u']  (N, L)
    dnll = (weights[:, None] * (su - upicked)).sum()
    return torch.stack((nll, dnll))


def plm_update_grad_reference(logits, codes, weights, picked=None, u=None, dh=None,
                              alpha: float = 0.0):
    """Plain version of :func:`plm_update_grad`: with ``u``, ``logits +=
    alpha*u'`` and ``picked += alpha*u'[code]`` in place (``u' = u +
    dh``); then the plm module's ``_ct_gh``."""
    from ..plm import _ct_gh, _pick_mask, _picked

    maskq = _pick_mask(codes, logits.shape[1])
    if u is not None:
        u = u + dh.T[None]
        logits.add_(u, alpha=alpha)
        picked.add_(_picked(u, maskq), alpha=alpha)
    return _ct_gh(logits, maskq, weights)


def _check_plm_passes(logits, codes, weights, picked, u, dh) -> None:
    if logits.dim() != 3:
        raise ValueError(f"logits must be (N, q, L), got shape {tuple(logits.shape)}")
    n, q, l = logits.shape
    want = {"logits": (logits, (n, q, l), torch.float32), "codes": (codes, (n, l), None),
            "weights": (weights, (n,), torch.float32), "picked": (picked, (n, l), torch.float32),
            "u": (u, (n, q, l), torch.float32), "dh": (dh, (l, q), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if t is None:
            continue
        if tuple(t.shape) != shape or t.device != logits.device:
            raise ValueError(f"{name} must be {shape} on {logits.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if logits.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if codes.dtype not in _INT_DTYPES:
        raise TypeError(f"codes must be an integer tensor, got {codes.dtype}")
    if logits.device.type == "cuda":
        if codes.dtype != torch.uint8:
            raise TypeError(f"codes must be uint8 on the card, got {codes.dtype}")
        if q not in _PLM_QS:
            raise ValueError(f"q must be one of {_PLM_QS} on the card, got {q}")
    elif logits.device.type != "cpu":
        raise ValueError(f"unsupported device {logits.device}")


def plm_trial(logits, codes, weights, picked, u, dh, alpha: float) -> torch.Tensor:
    """One line-search trial of the fused plmDCA step at ``alpha``: the
    float32 ``[sum_n,i w_n (lse - pk), sum_n,i w_n (E_softmax[u'] - u'_pk)]``
    at ``logits + alpha*u'``, ``u' = u + dh``, a ``(2,)`` tensor.

    ``logits``, ``u``: float32 ``(N, q, L)``, ``u`` the direction's
    couplings image; ``codes``: ``(N, L)`` observed states (uint8 on the
    card; a code >= q picks none); ``weights``: ``(N,)``; ``picked``:
    ``(N, L)`` logits of the observed states; ``dh``: the direction's
    fields ``(L, q)``.  On a CPU tensor this is
    :func:`plm_trial_reference`; on a CUDA tensor it launches
    ``csrc/plm_passes.cu`` (one pass over ``logits`` and ``u``) or raises.
    """
    _check_plm_passes(logits, codes, weights, picked, u, dh)
    if logits.device.type == "cpu":
        with span("plm_trial"):
            return plm_trial_reference(logits, codes, weights, picked, u, dh, alpha)
    n, q, l = logits.shape
    dev = logits.device
    out = torch.empty(2, dtype=torch.float32, device=dev)
    if n == 0 or l == 0:
        return out.zero_()
    lib = _plm_passes_lib()
    partial = torch.empty(2 * lib.plm_passes_blocks(n, l), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _launch_on(dev), span("plm_trial"):
        err = lib.plm_trial_launch(
            logits.data_ptr(), picked.data_ptr(), u.data_ptr(), dh.data_ptr(),
            codes.data_ptr(), weights.data_ptr(), n, q, l, float(alpha), partial.data_ptr(),
            _plm_ticket(dev.index, stream).data_ptr(), out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"plm_trial launch failed: CUDA error {err}")
    plm_trial.launches += 1
    return out


plm_trial.launches = 0


def plm_update_grad(logits, codes, weights, picked=None, u=None, dh=None, alpha: float = 0.0):
    """The fused plmDCA step's update and the gradient's cotangent:
    ``(ct, gh)`` with ``ct = w (softmax_q(logits) - onehot)`` float32
    ``(N, q, L)`` and ``gh = ct.sum(0)`` ``(q, L)``.

    With ``u`` (and ``picked``, ``dh``, ``alpha``), the logits are first
    moved along the direction in place: ``logits += alpha*u'``, ``picked
    += alpha*u'_pk``, ``u' = u + dh`` (shapes as in :func:`plm_trial`).
    On a CPU tensor this is :func:`plm_update_grad_reference`; on a CUDA
    tensor it launches ``csrc/plm_passes.cu`` (one pass that reads the
    logits and ``u`` and writes the logits and ``ct``, and a reduction of
    the per-block column sums) or raises.
    """
    if u is not None and (picked is None or dh is None):
        raise ValueError("an update along u needs picked and dh")
    _check_plm_passes(logits, codes, weights, picked, u, dh)
    if logits.device.type == "cpu":
        with span("plm_update_grad"):
            return plm_update_grad_reference(logits, codes, weights, picked, u, dh, alpha)
    n, q, l = logits.shape
    dev = logits.device
    ct = torch.empty_like(logits)
    gh = torch.empty((q, l), dtype=torch.float32, device=dev)
    if n == 0 or l == 0:
        return ct, gh.zero_()
    lib = _plm_passes_lib()
    gh_part = torch.empty(lib.plm_passes_row_blocks(n) * q * l, dtype=torch.float32,
                          device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with _launch_on(dev), span("plm_update_grad"):
        err = lib.plm_update_grad_launch(
            logits.data_ptr(), ptr(picked), ptr(u), ptr(dh), codes.data_ptr(),
            weights.data_ptr(), n, q, l, float(alpha), ct.data_ptr(), gh_part.data_ptr(),
            gh.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"plm_update_grad launch failed: CUDA error {err}")
    plm_update_grad.launches += 1
    return ct, gh


plm_update_grad.launches = 0


@functools.lru_cache(maxsize=None)
def _plm_ticket(index: int, stream: int) -> torch.Tensor:
    """The trial kernel's ticket for launches on ``stream`` of card
    ``index``: 0 between launches.  One a stream, since the launches that
    share a ticket must run in order."""
    return torch.zeros(1, dtype=torch.int32, device=torch.device("cuda", index))


@functools.lru_cache(maxsize=None)
def _plm_passes_lib() -> ctypes.CDLL:
    lib = _build.load("plm_passes")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.plm_trial_launch.argtypes = [p, p, p, p, p, p, i, i, i, f, p, p, p, p]
    lib.plm_update_grad_launch.argtypes = [p, p, p, p, p, p, i, i, i, f, p, p, p, p]
    lib.plm_trial_launch.restype = lib.plm_update_grad_launch.restype = ctypes.c_int
    lib.plm_passes_blocks.argtypes = [i, i]
    lib.plm_passes_blocks.restype = ctypes.c_longlong
    lib.plm_passes_row_blocks.argtypes = [i]
    lib.plm_passes_row_blocks.restype = ctypes.c_int
    n = ctypes.c_longlong
    lib.plm_lbfgs_coeffs_launch.argtypes = [p, p, p, f, i, i, p, p]
    lib.plm_lbfgs_border_launch.argtypes = [p, p, p, p, p, p, i, i, f, f, f, f, i, p]
    lib.plm_lbfgs_rows_launch.argtypes = [p, p, p, f, p, f, p, p, n, i, p]
    lib.plm_lbfgs_finish_launch.argtypes = [p, p, p, n, p]
    for name in ("coeffs", "border", "rows", "finish"):
        getattr(lib, f"plm_lbfgs_{name}_launch").restype = ctypes.c_int
    return lib


# ------------------------------------------- the fused step's L-BFGS algebra
_LBFGS_MAX_M = 32  # csrc/plm_passes.cu's MAX_HIST


def _lbfgs_launch(name: str, dev: torch.device, *args) -> None:
    """Launch ``plm_lbfgs_<name>_launch(*args, stream)`` on ``dev``'s
    current stream, without synchronising; raise on a launch error."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _launch_on(dev):
        err = getattr(_plm_passes_lib(), f"plm_lbfgs_{name}_launch")(*args, stream)
    if err != 0:
        raise RuntimeError(f"plm_lbfgs_{name} launch failed: CUDA error {err}")


def _lbfgs_check(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"the L-BFGS kernels take tensors on one card, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"the L-BFGS kernels take contiguous float32, got {t.dtype}")
    return dev


def lbfgs_coeffs_reference(zg: torch.Tensor, zzt: torch.Tensor, gg, k: int,
                           m: int) -> torch.Tensor:
    """The plain version of :func:`lbfgs_coeffs`: the m x m algebra in
    torch (``ops.lbfgs._compact_coeffs``; on CPU tensors LAPACK's solves),
    with the collapse to ``d = -g`` decided on the host."""
    from .lbfgs import _compact_coeffs  # ops.lbfgs imports this module

    gg = torch.as_tensor(gg, dtype=zg.dtype, device=zg.device)
    sy_mat = zzt[:m, m:]
    valid = torch.diagonal(sy_mat) != 0
    gamma, cfull = _compact_coeffs(zg[:m], zg[m:], sy_mat, zzt[m:, m:], valid, k, m)
    zg_c = torch.dot(zg, cfull)
    dg0 = -(gamma * gg + zg_c)
    dnorm2 = gamma * gamma * gg + 2.0 * gamma * zg_c + torch.dot(cfull, zzt @ cfull)
    if bool(dg0 >= 0):
        one = torch.ones((), dtype=zg.dtype, device=zg.device)
        return torch.cat([torch.stack([one, -gg, gg]), torch.zeros_like(cfull)])
    return torch.cat([torch.stack([gamma, dg0, torch.clamp_min(dnorm2, 1e-30)]), cfull])


def lbfgs_coeffs(zg: torch.Tensor, zzt: torch.Tensor, gg, k: int, m: int) -> torch.Tensor:
    """``[gamma, dg0, dnorm2, cfull...]`` ((2m + 3,) float32) of the
    Byrd-Nocedal-Schnabel direction ``d = -(gamma g + Z^T cfull)`` from the
    history's projections ``zg = Z g``, Gram ``zzt = Z Z^T`` and ``gg =
    ||g||^2`` (a 0-d tensor, or a host number) at iteration ``k``; ``(1,
    -gg, gg, 0)`` when the estimated ``dg0`` is not negative
    (``ops.lbfgs.direction_coeffs``).  On CPU tensors this is
    :func:`lbfgs_coeffs_reference`; on a card one launch of one thread,
    which makes the host wait for nothing."""
    if zg.device.type == "cpu":
        return lbfgs_coeffs_reference(zg, zzt, gg, k, m)
    if not 1 <= m <= _LBFGS_MAX_M or k < 0:
        raise ValueError(f"m must be in [1, {_LBFGS_MAX_M}] and k >= 0, got m={m}, k={k}")
    on_card = torch.is_tensor(gg)
    dev = _lbfgs_check(zg, zzt, *((gg,) if on_card else ()))
    out = torch.empty(2 * m + 3, dtype=torch.float32, device=dev)
    _lbfgs_launch("coeffs", dev, zg.data_ptr(), zzt.data_ptr(),
                  gg.data_ptr() if on_card else None, 0.0 if on_card else float(gg), int(k), m,
                  out.data_ptr())
    lbfgs_coeffs.launches += 1
    return out


lbfgs_coeffs.launches = 0


def _hist_dot(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``Z @ g`` in float32; bfloat16 rows are upcast one at a time
    (``pydca_tpu/plm.py:1102-1108``)."""
    if z.dtype == torch.float32:
        return torch.matmul(z, g)
    return torch.stack([torch.dot(row.float(), g) for row in z])


def lbfgs_history_reference(z, zzt, zg, g, d, g_new, k: int, alpha, dg0, dnorm2, gg, coeffs):
    """The plain version of :func:`lbfgs_history`, as torch operations
    (``pydca_tpu/plm.py:1110-1124``): where ``s . y`` is not above 1e-10
    the rows and the Gram stay as they are, by a select, not a branch on
    the host.  The rows are written in place; the Gram and projections
    are new tensors."""
    m = z.shape[0] // 2
    a = float(alpha)
    slot = k % m
    zg_new = _hist_dot(z, g_new)  # Z @ g' with the rows before the write
    gg_new, gog, dgn = torch.dot(g_new, g_new), torch.dot(g, g_new), torch.dot(d, g_new)
    sy = (dgn - float(dg0)) * a
    upd = sy > 1e-10
    s_row, y_row = d * a, g_new - g
    zg_upd = zg_new.clone()
    if z.dtype == torch.bfloat16:
        # the new rows as they will be stored, and their dots with g' (the
        # JAX package reads Z @ g' from the rounded rows)
        s_row, y_row = s_row.to(torch.bfloat16), y_row.to(torch.bfloat16)
        zg_upd[slot] = torch.dot(s_row.float(), g_new)
        zg_upd[slot + m] = torch.dot(y_row.float(), g_new)
    else:
        zg_upd[slot] = dgn * a  # s . g'
        zg_upd[slot + m] = gg_new - gog  # y . g'
    for row, new in ((slot, s_row), (slot + m, y_row)):
        torch.where(upd, new, z[row], out=z[row])
    del s_row, y_row
    # Z@s = alpha * Z@d = -alpha*(gamma*Zg + ZZt@c);  Z@y = Z@g' - Z@g
    zd = -zg if coeffs is None else -(coeffs[0] * zg + zzt @ coeffs[1])
    zs_vec = zd * a
    zs_vec[slot].fill_(float(alpha * alpha * dnorm2))  # a fill: a copy from the host would wait
    zs_vec[slot + m] = sy
    zy_vec = zg_upd - zg
    zy_vec[slot] = sy
    zy_vec[slot + m] = gg_new - 2.0 * gog + float(gg)
    bordered = zzt.clone()
    bordered[slot, :] = zs_vec
    bordered[:, slot] = zs_vec
    bordered[slot + m, :] = zy_vec
    bordered[:, slot + m] = zy_vec
    return torch.where(upd, bordered, zzt), torch.where(upd, zg_upd, zg_new), gg_new


def lbfgs_history(z, zzt, zg, g, d, g_new, k: int, alpha, dg0, dnorm2, gg, coeffs):
    """Write a taken step's rows ``s = alpha d`` and ``y = g' - g`` into
    slot ``k mod m`` of the history ``z`` ((2m, D) float32 or bfloat16
    rows, in place), border its float32 Gram ``zzt`` and set its
    projections ``zg`` to ``Z g'`` by scalar algebra, from the host's
    ``alpha``, ``dg0``, ``dnorm2`` (``||d||^2``) and ``gg`` (``||g||^2``)
    and the old gradient ``g``; where ``s . y`` is not above 1e-10 the rows
    and the Gram stay as they are.  ``coeffs``: the direction's ``(gamma,
    cfull)`` on the device, None after the steepest-descent fallback (d =
    -g).  Returns ``(zzt, zg, gg_new)``, ``gg_new = ||g'||^2`` a 0-d device
    tensor.  On CPU tensors this is :func:`lbfgs_history_reference`; on a
    card the dots and two launches, which make the host wait for nothing:
    one pass that writes the rows (rounded as ``.to(torch.bfloat16)`` rounds
    for bfloat16 rows, whose dots with ``g'`` are then taken from the rows
    as stored) and one thread that borders the Gram, both in place."""
    if z.device.type == "cpu":
        return lbfgs_history_reference(z, zzt, zg, g, d, g_new, k, alpha, dg0, dnorm2, gg,
                                       coeffs)
    m = z.shape[0] // 2
    if not 1 <= m <= _LBFGS_MAX_M:
        raise ValueError(f"m must be in [1, {_LBFGS_MAX_M}], got {m}")
    dev = _lbfgs_check(zzt, zg, g, d, g_new, *(coeffs or ()))
    rounded = z.dtype == torch.bfloat16
    if z.device != dev or z.dtype not in (torch.float32, torch.bfloat16) or not z.is_contiguous():
        raise TypeError(f"the history is contiguous float32 or bfloat16 rows on {dev}, got "
                        f"{z.dtype} on {z.device}")
    slot = k % m
    zg_new = _hist_dot(z, g_new)  # Z @ g' with the rows before the write
    dots = torch.empty(5 if rounded else 3, dtype=torch.float32, device=dev)
    for i, a in enumerate((g_new, g, d)):
        torch.dot(a, g_new, out=dots[i])
    s_row, y_row = z[slot], z[slot + m]
    _lbfgs_launch("rows", dev, d.data_ptr(), g_new.data_ptr(), g.data_ptr(), float(alpha),
                  dots.data_ptr(), float(dg0), s_row.data_ptr(), y_row.data_ptr(), d.numel(),
                  int(rounded))
    if rounded:
        for i, row in ((3, s_row), (4, y_row)):
            torch.dot(row.float(), g_new, out=dots[i])
    gp, cp = (None, None) if coeffs is None else (coeffs[0].data_ptr(), coeffs[1].data_ptr())
    _lbfgs_launch("border", dev, zzt.data_ptr(), zg.data_ptr(), zg_new.data_ptr(), gp, cp,
                  dots.data_ptr(), m, slot, float(alpha), float(dg0),
                  float(alpha * alpha * dnorm2), float(gg), int(rounded))
    lbfgs_history.launches += 1
    return zzt, zg, dots[0]


lbfgs_history.launches = 0


def lbfgs_finish(d: torch.Tensor, g: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """``d = -(gamma g + d)`` in place (``d`` holding ``Z^T c``), ``gamma``
    a 0-d tensor; returns ``d``.  On CPU tensors ``add_`` and ``neg_``; on
    a card one pass that reads ``gamma`` there."""
    if d.device.type == "cpu":
        return d.add_(g, alpha=float(gamma)).neg_()
    dev = _lbfgs_check(d, g, gamma)
    _lbfgs_launch("finish", dev, d.data_ptr(), g.data_ptr(), gamma.data_ptr(), d.numel())
    lbfgs_finish.launches += 1
    return d


lbfgs_finish.launches = 0
