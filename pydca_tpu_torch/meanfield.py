"""Mean-field DCA engine in PyTorch.

Port of the single-device FN half of ``pydca_tpu/meanfield.py``: sequence
weights -> weighted Gram -> regularised frequencies -> correlation matrix
``C`` -> couplings ``-C^{-1}`` -> FN and FN-APC scores (reference:
``pydca/meanfield_dca/meanfield_dca.py``).  The JAX package fuses these
steps into one jitted program (``_mf_fused_pipeline``); the port runs them
as a plain sequence of eager steps on one device, each timed as its own
stage (``weights``, ``gram``, ``corr``, ``inverse``, ``score``), and reads
the SPD flag and the FN vectors back to the host in one fetch.

The counting layer runs the two hand-written CUDA kernels on a card
(``csrc/identity_counts.cu`` for the weights, ``csrc/weighted_gram.cu``
for the Gram).  DI, fields, ``compute_params`` and a mesh are not ported
yet.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from . import score as score_mod
from . import stats
from .alphabets import get_alphabet
from .device import resolve_device, set_precision, sync
from .io.fasta import MSA, _dedup_encoded, read_msa
from .ops import linalg
from .profiling import StageTimers

logger = logging.getLogger(__name__)

__all__ = ["MeanFieldDCA", "MeanFieldDCAException"]

_FALLBACK_WARNING = (
    "Cholesky factorization produced non-finite couplings "
    "(C not numerically SPD; low Meff or tiny pseudocount?); "
    "falling back to an LU inverse"
)


class MeanFieldDCAException(Exception):
    """Errors specific to the mean-field DCA engine."""


def _as_msa(msa, biomolecule: str) -> MSA:
    """A path, an :class:`MSA`, an encoded (N, L) array or tensor, or an
    iterable of sequences / (id, sequence) pairs / SeqRecord-like objects
    (``pydca_tpu/meanfield.py:40-76``)."""
    if isinstance(msa, MSA):
        return msa
    if isinstance(msa, str):
        return read_msa(msa, biomolecule)
    if isinstance(msa, torch.Tensor):
        msa = msa.cpu().numpy()
    if isinstance(msa, np.ndarray):
        return MSA(data=np.asarray(msa, dtype=np.int8), alphabet=get_alphabet(biomolecule))
    try:
        alphabet = get_alphabet(biomolecule)
        seqs = []
        ids = []
        for item in msa:
            if isinstance(item, str):
                ids.append(f"seq{len(seqs)}")
                seqs.append(item.upper())
            elif hasattr(item, "id") and hasattr(item, "seq"):
                ids.append(str(item.id))
                seqs.append(str(item.seq).upper())
            else:
                sid, s = item
                ids.append(str(sid))
                seqs.append(str(s).upper())
        data, ids = _dedup_encoded(alphabet.encode_many(seqs), ids)
        return MSA(data=data, alphabet=alphabet, ids=ids)
    except Exception as exc:
        raise MeanFieldDCAException(f"cannot interpret MSA input: {exc}") from exc


class MeanFieldDCA:
    """Mean-field Direct Coupling Analysis on one device.

    Parameters
    ----------
    msa : str | MSA | np.ndarray | torch.Tensor | list
        Path to a FASTA file, an :class:`~pydca_tpu_torch.io.fasta.MSA`, an
        encoded ``(N, L)`` int array, or a list of sequences / (id, seq)
        pairs.
    biomolecule : str
        ``"protein"`` or ``"rna"``.
    pseudocount : float
        Relative pseudocount theta in [0, 1); default 0.5.
    seqid : float
        Sequence-identity threshold in (0, 1]; default 0.8.
    dtype : torch.dtype
        ``torch.float32`` (default) or ``torch.float64``: the dtype of the
        weights, the Gram, ``C`` and the couplings.
    device : str | torch.device
        ``"cuda"`` or ``"cpu"`` (explicit; no fallback).
    """

    def __init__(
        self,
        msa,
        biomolecule: str,
        pseudocount: float = 0.5,
        seqid: float = 0.8,
        *,
        dtype: torch.dtype = torch.float32,
        device,
    ):
        if not 0.0 <= pseudocount < 1.0:
            raise MeanFieldDCAException(
                f"pseudocount must be in [0, 1); got {pseudocount}"
            )
        if not 0.0 < seqid <= 1.0:
            raise MeanFieldDCAException(f"seqid must be in (0, 1]; got {seqid}")
        if dtype not in (torch.float32, torch.float64):
            raise MeanFieldDCAException(f"dtype must be float32 or float64; got {dtype}")
        self.device = resolve_device(device)
        set_precision()
        self.msa = _as_msa(msa, biomolecule)
        self.__pseudocount = float(pseudocount)
        self.__seqid = float(seqid)
        self.dtype = dtype
        # caches
        self.__weights: Optional[torch.Tensor] = None
        self.__gram: Optional[torch.Tensor] = None
        self.__couplings: Optional[torch.Tensor] = None
        self.__fn_raw: Optional[np.ndarray] = None
        self.__fn_apc: Optional[np.ndarray] = None
        self.lu_fallback = False  # set when the pipeline took the LU inverse
        self.timers = StageTimers()

    # ------------------------------------------------------------- properties
    @property
    def alignment(self) -> np.ndarray:
        """MSA in integer form, 1-based with gap = q (reference convention,
        ``meanfield_dca.py:140-147``).  Internal storage is 0-based."""
        return np.asarray(self.msa.data, dtype=np.int64) + 1

    @property
    def biomolecule(self) -> str:
        return self.msa.alphabet.name

    @property
    def sequences_len(self) -> int:
        return self.msa.seqs_len

    @property
    def num_sequences(self) -> int:
        return self.msa.num_seqs

    @property
    def num_site_states(self) -> int:
        return self.msa.q

    @property
    def pseudocount(self) -> float:
        return self.__pseudocount

    @property
    def sequence_identity(self) -> float:
        return self.__seqid

    @property
    def effective_num_sequences(self) -> float:
        return float(self.get_sequences_weight().sum())

    @property
    def sequences_weight(self) -> torch.Tensor:
        """Sequence weights (reference property ``meanfield_dca.py:186-193``)."""
        return self.get_sequences_weight()

    # ------------------------------------------------------------ statistics
    def _msa_tensor(self) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(self.msa.data)).to(self.device)

    def compute_sequences_weight(self) -> torch.Tensor:
        """Recompute sequence weights (reference ``meanfield_dca.py:212-233``)."""
        self.__weights = None
        return self.get_sequences_weight()

    def get_sequences_weight(self) -> torch.Tensor:
        if self.__weights is None:
            with self.timers.stage("weights"):
                self.__weights = stats.sequence_weights(
                    self._msa_tensor(), self.__seqid, self.msa.q, dtype=self.dtype
                )
                sync(self.device)
            self.timers.add_rate("weights", self.msa.num_seqs, "seqs")
        return self.__weights

    def _get_gram(self) -> torch.Tensor:
        if self.__gram is None:
            self.__gram = stats.weighted_gram(
                self._msa_tensor(), self.get_sequences_weight(), self.msa.q
            )
        return self.__gram

    def get_single_site_freqs(self) -> torch.Tensor:
        """Raw weighted ``fi`` of shape (L, q)."""
        l, q = self.msa.seqs_len, self.msa.q
        return torch.diagonal(self._get_gram()).reshape(l, q)

    def get_reg_single_site_freqs(self) -> torch.Tensor:
        return stats.regularize_fi(
            self.get_single_site_freqs(), self.msa.q, self.__pseudocount
        )

    def get_pair_site_freqs(self) -> torch.Tensor:
        """Raw ``fij`` of shape (P, q-1, q-1) (gap excluded, mf convention)."""
        return stats.pair_freqs_from_gram(self._get_gram(), self.msa.seqs_len, self.msa.q)

    def get_reg_pair_site_freqs(self) -> torch.Tensor:
        return stats.regularize_fij(
            self.get_pair_site_freqs(), self.msa.q, self.__pseudocount
        )

    def construct_corr_mat(self, reg_fi=None, reg_fij=None) -> torch.Tensor:
        """Correlation matrix ``C`` of shape (L(q-1), L(q-1)).

        With no arguments it is built in place from the weighted Gram
        matrix (:func:`stats.corr_mat_from_gram`).  Passing
        ``reg_fi``/``reg_fij`` mirrors the reference signature
        (``meanfield_dca.py:520-552``) and builds C from those frequencies.
        """
        l, q = self.msa.seqs_len, self.msa.q
        if reg_fi is None and reg_fij is None:
            return stats.corr_mat_from_gram(
                self._get_gram(), self.get_reg_single_site_freqs(),
                self.__pseudocount, l, q,
            )
        if reg_fi is None:
            reg_fi = self.get_reg_single_site_freqs()
        if reg_fij is None:
            reg_fij = self.get_reg_pair_site_freqs()
        return _corr_mat_from_freqs(
            torch.as_tensor(reg_fi, device=self.device),
            torch.as_tensor(reg_fij, device=self.device),
            l, q,
        )

    # -------------------------------------------------------------- couplings
    def compute_couplings(self, corr_mat=None) -> torch.Tensor:
        """Couplings ``-C^{-1}`` of shape (L(q-1), L(q-1)); cached.

        An explicit ``corr_mat`` (reference signature,
        ``meanfield_dca.py:555-585``) bypasses the cache.  C is symmetric
        positive definite for any pseudocount > 0, so the inverse is a
        Cholesky inverse; a failed factorisation falls back to an LU
        inverse with a warning (possible at very low Meff or a tiny
        pseudocount).
        """
        if corr_mat is not None:
            c = torch.as_tensor(corr_mat, device=self.device).to(self.dtype)
            return self._inverse_with_fallback(c)
        if self.__couplings is None:
            self._run_fused_pipeline()
        return self.__couplings

    def _run_fused_pipeline(self) -> None:
        """Populate the weights/couplings/FN caches: the steps of the JAX
        package's ``_mf_fused_pipeline`` (``pydca_tpu/meanfield.py:82-104``)
        in order, each a timed stage, then one device-to-host fetch.

        The Gram is freed once C is built (at L = 1000, q = 21 each is
        1.6-1.8 GB in float32).  C lives until the SPD flag is read, so the
        LU fallback inverts it without a second Gram; the inverse and the
        score stages each hold three such matrices at most.
        """
        l, q, pc = self.msa.seqs_len, self.msa.q, self.__pseudocount
        w = self.get_sequences_weight()
        timers = self.timers
        with timers.stage("gram"):
            gram = stats.weighted_gram(self._msa_tensor(), w, q)
            sync(self.device)
        with timers.stage("corr"):
            fi_reg = stats.regularize_fi(torch.diagonal(gram).reshape(l, q), q, pc)
            c = stats.corr_mat_from_gram(gram, fi_reg, pc, l, q)
            del gram
            sync(self.device)
        with timers.stage("inverse"):
            couplings, ok = self._cholesky_couplings(c)
            sync(self.device)
        with timers.stage("score"):
            fn_raw = score_mod.frobenius_norms_from_matrix(couplings, l, q - 1)
            fn_apc = score_mod.apc(fn_raw, l)
            # ONE device-to-host transfer: the SPD flag and the FN vectors
            host = torch.cat([ok.to(fn_raw.dtype).reshape(1), fn_raw, fn_apc]).cpu().numpy()
        p = fn_raw.shape[0]
        if not host[0]:
            self.lu_fallback = True
            del couplings
            with timers.stage("inverse"):
                self.__couplings = self._lu_couplings(c)
                sync(self.device)
            self.__fn_raw = None
            self.__fn_apc = None
            return
        self.__couplings = couplings
        self.__fn_raw = host[1 : 1 + p]
        self.__fn_apc = host[1 + p :]

    @staticmethod
    def _cholesky_couplings(c: torch.Tensor):
        """``(-C^{-1}, ok)`` by Cholesky; ``ok`` is a 0-d bool tensor on the
        device, true when the factorisation succeeded and the result is finite."""
        inv, info = linalg.spd_inverse(c)
        couplings = inv.neg_()
        return couplings, (info == 0) & torch.isfinite(couplings[0, 0])

    @staticmethod
    def _lu_couplings(c: torch.Tensor) -> torch.Tensor:
        logger.warning(_FALLBACK_WARNING)
        return -torch.linalg.inv_ex(c)[0]

    @classmethod
    def _inverse_with_fallback(cls, c: torch.Tensor) -> torch.Tensor:
        couplings, ok = cls._cholesky_couplings(c)
        return couplings if bool(ok.item()) else cls._lu_couplings(c)

    # ----------------------------------------------------------------- scores
    def _fn_scores(self):
        """FN scores (P,): the pipeline's host copy, else (after the LU
        fallback) the block reduction of the coupling matrix."""
        couplings = self.compute_couplings()
        if self.__fn_raw is not None:
            return self.__fn_raw
        return score_mod.frobenius_norms_from_matrix(
            couplings, self.msa.seqs_len, self.msa.q - 1
        )

    def compute_sorted_FN(self):
        self.compute_couplings()  # the pipeline times its own stages
        with self.timers.stage("score"):
            return score_mod.sorted_scores(self._fn_scores(), self.msa.seqs_len)

    def compute_sorted_FN_APC(self):
        self.compute_couplings()
        with self.timers.stage("score"):
            if self.__fn_apc is not None:
                apc = self.__fn_apc
            else:
                apc = score_mod.apc(self._fn_scores(), self.msa.seqs_len)
            return score_mod.sorted_scores(apc, self.msa.seqs_len)


def _corr_mat_from_freqs(
    reg_fi: torch.Tensor, reg_fij: torch.Tensor, l: int, q: int
) -> torch.Tensor:
    """Build C from explicit regularized frequencies.

    ``C[(i,a),(j,b)] = fij(i,j,a,b) - fi(i,a) fj(j,b)`` over the q-1 residue
    states, diagonal blocks ``fi(a) (delta_ab - fi(b))``
    (``pydca_tpu/meanfield.py:590-608``).
    """
    qm1 = q - 1
    fr = reg_fi[:, :qm1]
    iu, ju = (torch.from_numpy(a).to(fr.device) for a in np.triu_indices(l, k=1))
    f4 = torch.zeros((l, l, qm1, qm1), dtype=fr.dtype, device=fr.device)
    f4[iu, ju] = reg_fij.to(fr.dtype)
    f4[ju, iu] = reg_fij.transpose(-1, -2).to(fr.dtype)
    sites = torch.arange(l, device=fr.device)
    f4[sites, sites] = torch.diag_embed(fr)
    c4 = f4 - fr[:, None, :, None] * fr[None, :, None, :]
    return c4.permute(0, 2, 1, 3).reshape(l * qm1, l * qm1)
