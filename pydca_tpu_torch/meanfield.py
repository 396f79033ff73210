"""Mean-field DCA engine in PyTorch.

Port of the single-device part of ``pydca_tpu/meanfield.py``: sequence
weights -> weighted Gram -> regularised frequencies -> correlation matrix
``C`` -> couplings ``-C^{-1}`` -> FN, FN-APC, DI and DI-APC scores, local
fields and ``compute_params`` (reference:
``pydca/meanfield_dca/meanfield_dca.py``).  The JAX package fuses the steps
up to FN into one jitted program (``_mf_fused_pipeline``); the port runs
them as a plain sequence of eager steps on one device, each timed as its
own stage (``weights``, ``gram``, ``corr``, ``inverse``, ``score``), and
reads the SPD flag and the FN vectors back to the host in one fetch.  DI
adds the stages ``blocks``, ``two_site`` (the fixed point), ``di`` and
``sort``, and a reference sequence the stage ``backmap``.

The counting layer runs the two hand-written CUDA kernels on a card
(``csrc/identity_counts.cu`` for the weights, ``csrc/weighted_gram.cu``
for the Gram).  A mesh is not ported yet.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

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
        self.__fi: Optional[torch.Tensor] = None  # raw (L, q), the Gram's diagonal
        self.__couplings: Optional[torch.Tensor] = None
        self.__fn_raw: Optional[np.ndarray] = None
        self.__fn_apc: Optional[np.ndarray] = None
        self.lu_fallback = False  # set when the pipeline took the LU inverse
        # the last DI run's fixed-point statistics (score.TwoSiteStats)
        self.two_site_stats: Optional[score_mod.TwoSiteStats] = None
        # the last backmapped ranking's {MSA column -> refseq position}
        self.refseq_mapping: Optional[Dict[int, int]] = None
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

    def _tensor(self, x) -> torch.Tensor:
        """A caller's array or tensor on the engine's device (arrays copied)."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.tensor(np.asarray(x), device=self.device)

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
        """Raw weighted ``fi`` of shape (L, q), the Gram's diagonal.

        Kept once computed, from the pipeline's Gram or the cached one, so
        DI and the fields launch no second Gram (the Gram kernel is
        deterministic: the values are the same).
        """
        if self.__fi is None:
            self.__fi = _gram_fi(self._get_gram(), self.msa.seqs_len, self.msa.q)
        return self.__fi

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
        """Populate the weights/fi/couplings/FN caches: the steps of the JAX
        package's ``_mf_fused_pipeline`` (``pydca_tpu/meanfield.py:82-104``)
        in order, each a timed stage, then one device-to-host fetch.

        The Gram is freed once C is built (at L = 1000, q = 21 each is
        1.6-1.8 GB in float32); its (L, q) diagonal is kept as ``fi``.  C
        lives until the SPD flag is read, so the
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
            self.__fi = _gram_fi(gram, l, q)
            fi_reg = stats.regularize_fi(self.__fi, q, pc)
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

    def coupling_blocks(self) -> torch.Tensor:
        """Per-pair coupling blocks (P, q-1, q-1) for i < j in pair order."""
        return _pair_blocks(self.compute_couplings(), self.msa.seqs_len, self.msa.q - 1)

    def compute_fields(self, couplings=None) -> Dict[int, np.ndarray]:
        """Local fields ``h_i(a) = log(fi_a/fi_gap) - sum_{j != i} J_ij f_j``.

        Returns a dict {site: (q-1,) array} (``pydca_tpu/meanfield.py:403-419``,
        reference ``meanfield_dca.py:588-633``).  The sum over all sites is
        one matrix-vector product with the coupling matrix, less the
        diagonal blocks' term.
        """
        if couplings is None:
            couplings = self.compute_couplings()
        else:
            couplings = self._tensor(couplings)
        l, qm1 = self.msa.seqs_len, self.msa.q - 1
        fi = self.get_reg_single_site_freqs().to(couplings.dtype)
        fr = fi[:, :qm1]  # (L, q-1)
        total = (couplings @ fr.reshape(-1)).reshape(l, qm1)
        diag = couplings.reshape(l, qm1, l, qm1).diagonal(dim1=0, dim2=2)  # (a, b, i)
        self_term = (diag.permute(2, 0, 1) * fr[:, None, :]).sum(dim=-1)
        fields = (torch.log(fr / fi[:, -1:]) - (total - self_term)).cpu().numpy()
        return {i: fields[i] for i in range(l)}

    def shift_couplings(self, couplings_ij) -> np.ndarray:
        """Zero-sum-gauge shift of one (q-1)^2 coupling block."""
        qm1 = self.msa.q - 1
        block = torch.as_tensor(np.asarray(couplings_ij)).reshape(qm1, qm1)
        return score_mod.gauge_shift(block).numpy()

    def compute_two_site_model_fields(self, couplings=None, reg_fi=None) -> np.ndarray:
        """Two-site-model fields, shape ``(P, 2, q)``
        (``pydca_tpu/meanfield.py:428-444``, reference
        ``meanfield_dca.py:555-585`` / ``msa_numerics.py:377-442``)."""
        l, q = self.msa.seqs_len, self.msa.q
        if couplings is None:
            blocks = self.coupling_blocks()
        else:
            blocks = _pair_blocks(self._tensor(couplings), l, q - 1)
        reg_fi = self.get_reg_single_site_freqs() if reg_fi is None else self._tensor(reg_fi)
        hi, hj = score_mod.two_site_model_fields(blocks, reg_fi, l, q)
        return torch.stack([hi, hj], dim=1).cpu().numpy()

    def get_site_pair_di_score(self) -> Dict[Tuple[int, int], float]:
        """Unsorted DI per pair as a dict ``{(i, j): score}``
        (reference ``meanfield_dca.py:793-830``)."""
        di = self._di_scores().cpu().numpy()
        iu, ju = np.triu_indices(self.msa.seqs_len, k=1)
        return {(int(i), int(j)): float(s) for i, j, s in zip(iu, ju, di)}

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

    def _di_scores(self) -> torch.Tensor:
        """DI (P,) on the device, each step a timed stage; the fixed point's
        statistics are kept in ``two_site_stats``."""
        self.compute_couplings()  # the pipeline times its own stages
        di, self.two_site_stats = score_mod.engine_di(self)
        return di

    def compute_sorted_FN(self, seqbackmapper=None):
        self.compute_couplings()  # the pipeline times its own stages
        with self.timers.stage("score"):
            res = score_mod.sorted_scores(self._fn_scores(), self.msa.seqs_len)
        return score_mod.backmapped(self, res, seqbackmapper)

    def compute_sorted_FN_APC(self, seqbackmapper=None):
        self.compute_couplings()
        with self.timers.stage("score"):
            if self.__fn_apc is not None:
                apc = self.__fn_apc
            else:
                apc = score_mod.apc(self._fn_scores(), self.msa.seqs_len)
            res = score_mod.sorted_scores(apc, self.msa.seqs_len)
        return score_mod.backmapped(self, res, seqbackmapper)

    def compute_sorted_DI(self, seqbackmapper=None):
        di = self._di_scores()
        with self.timers.stage("sort"):
            res = score_mod.sorted_scores(di, self.msa.seqs_len)
        return score_mod.backmapped(self, res, seqbackmapper)

    def compute_sorted_DI_APC(self, seqbackmapper=None):
        di = self._di_scores()
        with self.timers.stage("sort"):
            l = self.msa.seqs_len
            res = score_mod.sorted_scores(score_mod.apc(di, l), l)
        return score_mod.backmapped(self, res, seqbackmapper)

    def get_mapped_site_pairs_dca_scores(self, sorted_dca_scores, seqbackmapper):
        """Sorted scores mapped onto the reference sequence
        (reference ``meanfield_dca.py:755-790``)."""
        return score_mod.backmapped(self, sorted_dca_scores, seqbackmapper)

    # ------------------------------------------------------------ parameters
    def compute_params(
        self,
        seqbackmapper=None,
        ranked_by: Optional[str] = None,
        linear_dist: Optional[int] = None,
        num_site_pairs: Optional[int] = None,
    ):
        """Fields plus top-ranked gauge-shifted couplings.

        Mirrors ``pydca_tpu/meanfield.py:527-587`` (reference
        ``meanfield_dca.py:661-752``): couplings of the top
        ``num_site_pairs`` pairs with ``|i - j| > linear_dist`` (default 4)
        ranked by ``ranked_by`` (default FN_APC), each block gauge-shifted.
        With a backmapper, sites are reference positions and
        ``num_site_pairs`` defaults to the reference's length; else to L.
        The blocks are gathered on the device, not copied to the host with
        the whole coupling matrix.
        """
        rank = score_mod.ranking_method(self, ranked_by, MeanFieldDCAException)
        dca_scores = rank(seqbackmapper=seqbackmapper)
        l, qm1 = self.msa.seqs_len, self.msa.q - 1
        couplings = self.compute_couplings()
        fields = self.compute_fields(couplings=couplings)
        sites, n_pairs = score_mod.params_sites(self, seqbackmapper, num_site_pairs)
        pairs = score_mod.ranked_pairs(
            dca_scores, 4 if linear_dist is None else linear_dist, n_pairs
        )
        cols = torch.tensor([(sites[i], sites[j]) for i, j in pairs], dtype=torch.int64,
                            device=self.device).reshape(-1, 2)
        j4 = couplings.reshape(l, qm1, l, qm1).permute(0, 2, 1, 3)
        shifted = score_mod.gauge_shift(j4[cols[:, 0], cols[:, 1]])
        shifted = shifted.reshape(len(pairs), qm1 * qm1).cpu().numpy()
        return tuple((i, fields[c]) for i, c in sites.items()), tuple(zip(pairs, shifted))


def _gram_fi(gram: torch.Tensor, l: int, q: int) -> torch.Tensor:
    """The Gram's (L, q) diagonal ``fi``, as a copy (a view would keep the
    whole Gram alive)."""
    return torch.diagonal(gram).reshape(l, q).clone()


def _pair_blocks(couplings: torch.Tensor, l: int, qm1: int) -> torch.Tensor:
    """The (P, q-1, q-1) blocks ``J[(i, a), (j, b)]`` for i < j in pair
    order: a gather from the permuted view of the (L(q-1))^2 matrix, with no
    (L, L, q-1, q-1) copy (1.6 GB in float32 at L = 1000, q = 21)."""
    iu, ju = score_mod.pair_sites(l, couplings.device)
    return couplings.reshape(l, qm1, l, qm1).permute(0, 2, 1, 3)[iu, ju]


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
