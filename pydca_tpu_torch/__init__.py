"""pydca_tpu_torch: the PyTorch/CUDA port of pydca_tpu.

Same module layout as ``pydca_tpu`` (the JAX package, kept as the reference
the port is tested against), so each function's counterpart sits under the
same path, and the same top-level names (``pydca_tpu/__init__.py``).  The
package imports ``torch`` and numpy only; hand-written CUDA kernels live
under ``csrc/`` and are compiled with ``nvcc`` at first use, the FASTA
codec under ``native/`` with ``g++`` (see :mod:`pydca_tpu_torch.ops._build`
and :mod:`pydca_tpu_torch.runtime` for where they are cached).

Ported: the ``plmdca`` and ``mfdca`` subcommands (FN, DI, parameters and
frequencies, streamed deep fits, checkpoints, family batches and
``warmup``), ``--refseq_file`` backmapping with the template search on the
engine's device (:mod:`~pydca_tpu_torch.backmap`), the ``pydca`` CLI's
trimming and contact evaluation (:mod:`~pydca_tpu_torch.trim`,
:mod:`~pydca_tpu_torch.eval`), the reference's 1-based reader
(:mod:`~pydca_tpu_torch.fasta_reader`), ``a2m2aln``
(:mod:`~pydca_tpu_torch.extras`), and data parallelism over the sequences
with ``torch.distributed``, one process per card
(:mod:`~pydca_tpu_torch.parallel`; the CLIs start one rank a card
themselves under ``--mesh auto --device cuda``).
"""

__version__ = "0.1.0"

from .alphabets import PROTEIN, RNA, Alphabet, get_alphabet
from .io.fasta import MSA, read_msa
from .meanfield import MeanFieldDCA

__all__ = [
    "Alphabet",
    "PROTEIN",
    "RNA",
    "get_alphabet",
    "MSA",
    "read_msa",
    "MeanFieldDCA",
    "PlmDCA",
]


def __getattr__(name):
    # Lazy import, as in pydca_tpu/__init__.py.
    if name == "PlmDCA":
        from .plm import PlmDCA

        return PlmDCA
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
