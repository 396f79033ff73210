"""The plain reference of the benchmark: plain PyTorch, written apart from
the program, that works out again from the benchmark's own inputs what a
job derives (sequence weights, the plmDCA objective and its gradient, the
mean-field couplings ``-C^{-1}``, FN-APC scores), and judges the program's
outputs against it (:mod:`.judge`).

It imports nothing of the program, of the JAX package or of JAX.  The
control (:mod:`.control`) is this reference put in the program's place at
the nearest precision below the configuration's: TF32 products, emulated by
rounding each product's operands to TF32 (:func:`tf32`), so that it reads
the same on the CPU and on the card.
"""

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest with
    ties away from zero, as the tensor cores take their operands; returned
    as float32."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def one_hot(codes: torch.Tensor, q: int, dtype) -> torch.Tensor:
    """(N, L) codes -> (N, L*q) one-hot, column ``j*q + b``."""
    n, l = codes.shape
    x = torch.zeros((n, l, q), dtype=dtype, device=codes.device)
    x.scatter_(2, codes.long().unsqueeze(2), 1.0)
    return x.reshape(n, l * q)
