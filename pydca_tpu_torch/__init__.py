"""pydca_tpu_torch: the PyTorch/CUDA port of pydca_tpu.

Same module layout as ``pydca_tpu`` (the JAX package, kept as the reference
the port is tested against), so each function's counterpart sits under the
same path.  The package imports ``torch`` and numpy only; hand-written CUDA
kernels live under ``csrc/`` and are compiled with ``nvcc`` at first use
(see :mod:`pydca_tpu_torch.ops._build`).

Ported so far, on one device: the ``plmdca`` and ``mfdca`` subcommands
(FN, DI, parameters and frequencies, streamed deep fits, checkpoints and
family batches), ``--refseq_file`` backmapping with the template search on
the engine's device (:mod:`~pydca_tpu_torch.backmap`), and the ``pydca``
CLI's trimming and contact evaluation (:mod:`~pydca_tpu_torch.trim`,
:mod:`~pydca_tpu_torch.eval`).
"""

__version__ = "0.1.0"
