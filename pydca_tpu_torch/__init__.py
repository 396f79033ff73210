"""pydca_tpu_torch: the PyTorch/CUDA port of pydca_tpu.

Same module layout as ``pydca_tpu`` (the JAX package, kept as the reference
the port is tested against), so each function's counterpart sits under the
same path.  The package imports ``torch`` and numpy only; hand-written CUDA
kernels live under ``csrc/`` and are compiled with ``nvcc`` at first use
(see :mod:`pydca_tpu_torch.ops._build`).

Ported so far, on one device: the ``plmdca compute_fn [--apc]`` main path
(FASTA decode, sequence weights, the fused full-batch L-BFGS fit, FN/APC
scoring, the ranked output file) and the mean-field ``mfdca compute_fn
[--apc]`` path (weights, weighted Gram, correlation matrix, Cholesky
inverse, FN/APC).
"""

__version__ = "0.1.0"
