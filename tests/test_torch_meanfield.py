"""Port's mean-field engine vs the JAX package's, on the CPU.

Both engines get the same seeded alignment.  In float64 the port must
reproduce the JAX engine's weights exactly and its couplings, FN and FN-APC
to rtol 1e-8; the float32 engines are held to the ranking bar the JAX
package holds itself to (``tests/test_ref_parity.py:283-284``).
"""

import logging

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pydca_tpu.alphabets import PROTEIN as JPROTEIN, RNA as JRNA
from pydca_tpu.io.fasta import MSA as JMSA
from pydca_tpu.meanfield import MeanFieldDCA as JMeanFieldDCA
from pydca_tpu_torch.alphabets import PROTEIN, RNA
from pydca_tpu_torch.io.fasta import MSA
from pydca_tpu_torch.meanfield import MeanFieldDCA, MeanFieldDCAException
from pydca_tpu_torch.synthetic import planted_family, spearman, top_k_overlap
from test_meanfield import small_msa


FAMILIES = {
    "small_msa": lambda: (small_msa(), "rna"),  # tests/test_meanfield.py's, q = 5
    "q21_family": lambda: (
        planted_family(220, 23, 21, seed=5, n_pairs=4, n_ancestors=16)[0], "protein"
    ),
}


def engines(which, dtype):
    """(data, JAX engine, port engine) on the same encoded alignment."""
    data, bio = FAMILIES[which]()
    jalph, talph = (JRNA, RNA) if bio == "rna" else (JPROTEIN, PROTEIN)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    j = JMeanFieldDCA(JMSA(data=data, alphabet=jalph), bio, dtype=jdt)
    t = MeanFieldDCA(MSA(data=data, alphabet=talph), bio, dtype=dtype, device="cpu")
    return data, j, t


def dense(sorted_scores, l):
    out = np.full(l * (l - 1) // 2, np.nan)
    for (i, j), s in sorted_scores:
        out[l * (l - 1) // 2 - (l - i) * (l - i - 1) // 2 + j - i - 1] = s
    return out


@pytest.mark.parametrize("which", sorted(FAMILIES))
def test_float64_engine_equals_jax(which):
    data, j, t = engines(which, torch.float64)
    l = data.shape[1]
    np.testing.assert_array_equal(
        t.get_sequences_weight().numpy(), np.asarray(j.get_sequences_weight())
    )
    jc, tc = np.asarray(j.compute_couplings()), t.compute_couplings().numpy()
    assert tc.dtype == np.float64 and tc.shape == jc.shape
    np.testing.assert_allclose(tc, jc, rtol=1e-8, atol=1e-8 * np.abs(jc).max())
    for name in ("compute_sorted_FN", "compute_sorted_FN_APC"):
        got, want = dense(getattr(t, name)(), l), dense(getattr(j, name)(), l)
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)
    assert not t.lu_fallback


def test_staged_methods_equal_jax():
    _, j, t = engines("q21_family", torch.float64)
    pairs = [
        ("get_single_site_freqs", 1e-12),
        ("get_reg_single_site_freqs", 1e-12),
        ("get_pair_site_freqs", 1e-12),
        ("get_reg_pair_site_freqs", 1e-12),
        ("construct_corr_mat", 1e-12),
    ]
    for name, tol in pairs:
        np.testing.assert_allclose(
            getattr(t, name)().numpy(), np.asarray(getattr(j, name)()), rtol=tol, atol=1e-15,
            err_msg=name,
        )
    # C from explicit frequencies (the reference signature) equals C from the Gram
    c_freqs = t.construct_corr_mat(t.get_reg_single_site_freqs(), t.get_reg_pair_site_freqs())
    np.testing.assert_allclose(c_freqs.numpy(), t.construct_corr_mat().numpy(), rtol=1e-12, atol=1e-15)
    # an explicit corr_mat bypasses the cache and inverts it
    c = t.construct_corr_mat()
    np.testing.assert_allclose(
        t.compute_couplings(corr_mat=c).numpy(),
        np.asarray(j.compute_couplings(corr_mat=np.asarray(j.construct_corr_mat()))),
        rtol=1e-8, atol=1e-10,
    )
    assert t.effective_num_sequences == pytest.approx(j.effective_num_sequences, rel=1e-12)
    np.testing.assert_array_equal(t.alignment, j.alignment)


@pytest.mark.parametrize("which", sorted(FAMILIES))
def test_float32_engine_rank_bar(which):
    data, j, t = engines(which, torch.float32)
    l = data.shape[1]
    assert t.get_sequences_weight().dtype == torch.float32
    np.testing.assert_array_equal(
        t.get_sequences_weight().numpy(), np.asarray(j.get_sequences_weight())
    )
    for name in ("compute_sorted_FN", "compute_sorted_FN_APC"):
        got, want = getattr(t, name)(), getattr(j, name)()
        assert spearman(got, want, l) >= 0.98
        assert top_k_overlap(got, want, 20) >= 0.9


def test_couplings_lu_fallback_on_non_spd(caplog):
    """Mirror of tests/test_meanfield.py: a non-SPD C falls back to LU."""
    c = torch.tensor(np.diag([1.0, -2.0, 3.0, -4.0]))
    with caplog.at_level(logging.WARNING, logger="pydca_tpu_torch.meanfield"):
        out = MeanFieldDCA._inverse_with_fallback(c).numpy()
    assert any("falling back to an LU inverse" in r.message for r in caplog.records)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, -np.diag([1.0, -0.5, 1 / 3, -0.25]), rtol=1e-6)


def test_fused_pipeline_non_spd_takes_lu_fallback(caplog):
    """3 distinct sequences, pseudocount 0: C is rank-deficient, the
    Cholesky factorisation fails, and the engine warns, drops the FN
    caches and inverts by LU (values may be non-finite, as in JAX)."""
    data = np.array(
        [[0, 1, 2, 3, 0, 1], [1, 2, 3, 0, 1, 2], [2, 3, 0, 1, 2, 3]], dtype=np.int8
    )
    inst = MeanFieldDCA(MSA(data=data, alphabet=RNA), "rna", pseudocount=0.0, device="cpu")
    with caplog.at_level(logging.WARNING, logger="pydca_tpu_torch.meanfield"):
        scores = inst.compute_sorted_FN_APC()
    messages = [r.message for r in caplog.records]
    assert (
        "Cholesky factorization produced non-finite couplings "
        "(C not numerically SPD; low Meff or tiny pseudocount?); "
        "falling back to an LU inverse"
    ) in messages
    assert inst.lu_fallback
    assert inst._MeanFieldDCA__gram is None  # the fallback inverts the pipeline's C
    assert len(scores) == 6 * 5 // 2
    assert len(inst.compute_sorted_FN()) == 6 * 5 // 2


@pytest.mark.parametrize(
    "kwargs",
    [{"pseudocount": 1.0}, {"pseudocount": -0.1}, {"seqid": 0.0}, {"seqid": 1.5},
     {"dtype": torch.float16}],
    ids=["pc_one", "pc_negative", "seqid_zero", "seqid_above_one", "dtype"],
)
def test_bad_parameters_raise(kwargs):
    with pytest.raises(MeanFieldDCAException):
        MeanFieldDCA(small_msa(), "rna", device="cpu", **kwargs)


def test_msa_inputs_match_jax():
    """Sequence strings, (id, seq) pairs and encoded arrays or tensors:
    the same encoded, deduplicated alignment as the JAX engine."""
    data = small_msa()
    seqs = RNA.decode_many(data)
    for msa in (seqs + seqs[:3], [(f"s{k}", s.lower()) for k, s in enumerate(seqs)]):
        t = MeanFieldDCA(msa, "rna", device="cpu")
        j = JMeanFieldDCA(msa, "rna")
        np.testing.assert_array_equal(t.msa.data, np.asarray(j.msa.data))
        assert t.msa.ids == j.msa.ids
    for msa in (data, torch.tensor(data)):
        np.testing.assert_array_equal(MeanFieldDCA(msa, "rna", device="cpu").msa.data, data)
    with pytest.raises(MeanFieldDCAException):
        MeanFieldDCA([1, 2, 3], "rna", device="cpu")
