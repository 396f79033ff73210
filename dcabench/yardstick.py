"""The yardstick: the card's peaks, and the operations and bytes that each
measured piece of work needs, computed from its shapes.

``PEAK``, ``identity_bound``, ``gram_bound`` and ``bound_of`` are frozen
copies of ``chip_smoke.py:165-168`` and ``chip_smoke.py:296-342``; the
plmDCA and inverse counts are the benchmark's own model (4·N·(Lq)² flops
an L-BFGS iteration: one forward and one backward logits product at each
accepted iterate; D³ for a Cholesky factorisation and the inverse from
its factor).  Bounds are in seconds here (``chip_smoke.py`` gives
milliseconds), and ``gram_bound`` takes the element's bytes where the
original takes a torch dtype.
"""

from __future__ import annotations

PEAK = {  # NVIDIA H100 SXM data sheet, dense, at its 700 W power limit
    "bf16": 989e12, "f64_tensor": 67e12, "int8": 1979e12, "bytes": 3.35e12,
    "f32": 67e12, "f64": 34e12,  # outside the tensor cores
}

# the flop rate that bounds a product computed in each configuration precision
PRODUCT_PEAK = {"float32": PEAK["f32"], "bfloat16": PEAK["bf16"]}


def bound_of(op_s: float, byte_s: float):
    """(seconds, what bounds it) from the operations' and the bytes' seconds."""
    return (op_s, "operations") if op_s >= byte_s else (byte_s, "bytes")


def identity_bound(n, l, q):
    """The least time of the identity counts on an H100 (700 W): the
    larger of the N(N+1)/2 row pairs' one-hot products (L*q int8 multiply-
    adds each) at 1979 TOP/s and reading the N*L code bytes at 3.35 TB/s."""
    return bound_of(n * (n + 1) / 2 * l * q * 2 / PEAK["int8"], n * l / PEAK["bytes"])


def gram_bound(n, l, q, item: int = 4):
    """The least time of the Gram on an H100 (700 W): the larger of its
    non-zero products, one add per sequence and site pair on the upper
    triangle (N*L*(L+1)/2, an FMA's 2 flop each at the float32 (``item``
    4) or float64 (8) rate outside the tensor cores), and its bytes (codes
    and weights read, K^2 elements written) at 3.35 TB/s."""
    adds = n * l * (l + 1) / 2
    return bound_of(2 * adds / PEAK["f32" if item == 4 else "f64"],
                    (n * l + n * item + (l * q) ** 2 * item) / PEAK["bytes"])


def plm_iter_flops(n, l, q):
    """Model flops of one L-BFGS iteration of plmDCA on N sequences: the
    forward logits product (N, Lq) @ (Lq, Lq) at the accepted iterate and
    the backward one, 2·N·(Lq)² each."""
    return 4.0 * n * (l * q) ** 2


def plm_iter_bytes(n, l, q, item: int = 4):
    """The least bytes of the same two products: the one-hot read twice,
    the logits written and their cotangent read (N·Lq each), the coupling
    operand read and its gradient written ((Lq)² each)."""
    return item * (4.0 * n * l * q + 2.0 * (l * q) ** 2)


def plm_fit_bound(n, l, q, iters, precision: str = "float32"):
    """The least time of ``iters`` iterations: (seconds, what bounds it)."""
    return bound_of(iters * plm_iter_flops(n, l, q) / PRODUCT_PEAK[precision],
                    iters * plm_iter_bytes(n, l, q) / PEAK["bytes"])


def spd_inverse_flops(d):
    """Cholesky (D³/3) and the inverse from the factor (2D³/3)."""
    return float(d) ** 3


def mf_job_flops(n, l, q):
    """Useful flops of one mean-field solve: the Gram's non-zero products
    (2·N·L(L+1)/2, as :func:`gram_bound` counts them) and the inverse of
    C (D = L(q-1))."""
    return n * l * (l + 1) + spd_inverse_flops(l * (q - 1))
