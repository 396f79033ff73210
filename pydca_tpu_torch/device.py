"""Device selection, matmul precision and synchronisation.

Every public entry point of the port takes an explicit ``device``; nothing
here sets a global default device.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "set_precision", "sync"]


def resolve_device(name) -> torch.device:
    """``"cuda"`` (or ``"cuda:k"``) or ``"cpu"`` -> ``torch.device``.

    A CUDA request raises when no card is visible: the port never falls
    back to the CPU on its own.
    """
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() "
                "is False"
            )
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}; use 'cuda' or 'cpu'")
    return dev


def set_precision() -> None:
    """Run float32 contractions in full float32 (TF32 off), and bfloat16
    products without reduced-precision reductions.

    The JAX package pins its frequency and count contractions to
    ``Precision.HIGHEST`` (``pydca_tpu/stats.py:209,233``,
    ``pydca_tpu/ops/pallas_kernels.py:172``); TF32 keeps only ~3 decimal
    digits.  The bfloat16 logits products (``precision="bfloat16"``)
    accumulate in float32, as ``preferred_element_type=float32`` does.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def sync(device) -> None:
    """Wait for all queued work on ``device`` (a no-op on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
