"""Port's weighted Gram, mean-field statistics, SPD inverse and matrix FN
vs the JAX package.

The port runs its plain PyTorch versions on the CPU; the JAX side runs the
Pallas ``weighted_gram`` in interpret mode and the XLA ``stats`` functions.
Inputs are made from a seed with numpy and handed to both.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pydca_tpu import score as jscore
from pydca_tpu import stats as jstats
from pydca_tpu.ops import linalg as jlinalg
from pydca_tpu.ops import pallas_kernels as pk
from pydca_tpu_torch import score as tscore
from pydca_tpu_torch import stats as tstats
from pydca_tpu_torch.ops import _build
from pydca_tpu_torch.ops import cuda_kernels as ck
from pydca_tpu_torch.ops import linalg as tlinalg

SHAPES = [(50, 7, 5), (64, 11, 21), (97, 37, 21)]  # the last is ragged in N and K


def family(n, l, q, seed):
    """A few ancestors plus point mutations, and positive weights."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, q, size=(6, l))
    msa = base[rng.integers(0, 6, size=n)]
    hit = rng.random((n, l)) < 0.3
    msa = np.where(hit, rng.integers(0, q, size=(n, l)), msa).astype(np.int32)
    return msa, rng.uniform(0.05, 1.0, size=n)


@pytest.mark.parametrize("n,l,q", SHAPES)
def test_weighted_gram_f32_equals_jax(n, l, q):
    msa, w = family(n, l, q, seed=n + l + q)
    w32 = w.astype(np.float32)
    got = ck.weighted_gram(torch.tensor(msa), torch.tensor(w32), q).numpy()
    assert got.dtype == np.float32 and got.shape == (l * q, l * q)
    onehot = np.eye(q, dtype=np.float32)[msa].reshape(n, l * q)
    pallas = pk.weighted_gram(
        jnp.asarray(onehot), jnp.asarray(w32), block_n=16, block_k=128, interpret=True
    )
    xla = jstats.weighted_gram(jnp.asarray(msa), jnp.asarray(w32), q) * jnp.sum(w32)
    # float32 sums of the same exact products in another order
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, np.asarray(xla), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got, got.T)


@pytest.mark.parametrize("n,l,q", SHAPES)
def test_weighted_gram_f64_equals_jax(n, l, q):
    msa, w = family(n, l, q, seed=n * l)
    got = tstats.weighted_gram(torch.tensor(msa), torch.tensor(w), q)
    assert got.dtype == torch.float64
    want = jstats.weighted_gram(jnp.asarray(msa), jnp.asarray(w), q)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("n,l,q", [(80, 9, 5), (97, 13, 21)])
def test_pair_site_freqs_equal_jax(n, l, q):
    msa, w = family(n, l, q, seed=4)
    got = tstats.pair_site_freqs(torch.tensor(msa), torch.tensor(w), q)
    want = jstats.pair_site_freqs(jnp.asarray(msa), jnp.asarray(w), q)
    assert got.shape == want.shape == (l * (l - 1) // 2, q - 1, q - 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-15)


def test_regularize_equal_jax():
    rng = np.random.default_rng(2)
    fi, fij = rng.random((9, 21)), rng.random((36, 20, 20))
    np.testing.assert_allclose(
        tstats.regularize_fi(torch.tensor(fi), 21, 0.5).numpy(),
        np.asarray(jstats.regularize_fi(jnp.asarray(fi), 21, 0.5)), rtol=1e-12,
    )
    np.testing.assert_allclose(
        tstats.regularize_fij(torch.tensor(fij), 21, 0.3).numpy(),
        np.asarray(jstats.regularize_fij(jnp.asarray(fij), 21, 0.3)), rtol=1e-12,
    )


@pytest.mark.parametrize("n,l,q,pc", [(80, 9, 5, 0.5), (97, 13, 21, 0.2)])
def test_corr_mat_from_gram_equals_jax(n, l, q, pc):
    msa, w = family(n, l, q, seed=7)
    tg = tstats.weighted_gram(torch.tensor(msa), torch.tensor(w), q)
    jg = jstats.weighted_gram(jnp.asarray(msa), jnp.asarray(w), q)
    tfi = tstats.regularize_fi(torch.diagonal(tg).reshape(l, q), q, pc)
    jfi = jstats.regularize_fi(jnp.diagonal(jg).reshape(l, q), q, pc)
    got = tstats.corr_mat_from_gram(tg, tfi, pc, l, q)
    want = jstats.corr_mat_from_gram(jg, jfi, pc, l, q)
    assert got.shape == (l * (q - 1), l * (q - 1)) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-15)


def test_spd_inverse_equals_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((300, 300))
    c = a @ a.T / 300 + 0.5 * np.eye(300)
    got, info = tlinalg.spd_inverse(torch.tensor(c))
    want = np.asarray(jlinalg.spd_inverse(jnp.asarray(c)))
    assert int(info) == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(got.numpy(), got.numpy().T)


def test_spd_inverse_reports_failed_factorisation():
    c = torch.tensor(np.diag([1.0, -2.0, 3.0, -4.0]))
    _, info = tlinalg.spd_inverse(c)
    assert int(info) > 0


@pytest.mark.parametrize("l,qm1", [(9, 4), (12, 20)])
def test_frobenius_norms_from_matrix_equal_jax(l, qm1):
    rng = np.random.default_rng(l)
    m = rng.standard_normal((l * qm1, l * qm1))
    m = (m + m.T) / 2
    got = tscore.frobenius_norms_from_matrix(torch.tensor(m), l, qm1)
    want = jscore.frobenius_norms_from_matrix(jnp.asarray(m), l, qm1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)
    iu, ju = np.triu_indices(l, k=1)
    blocks = m.reshape(l, qm1, l, qm1).transpose(0, 2, 1, 3)[iu, ju]
    np.testing.assert_allclose(
        got.numpy(), tscore.frobenius_norms(torch.tensor(blocks)).numpy(), rtol=1e-10
    )


def test_weighted_gram_cpu_path_does_not_count_launches():
    msa, w = family(10, 6, 5, seed=2)
    before = ck.weighted_gram.launches
    ck.weighted_gram(torch.tensor(msa), torch.tensor(w), 5)
    assert ck.weighted_gram.launches == before


@pytest.mark.parametrize(
    "codes,weights,err",
    [
        (torch.full((6, 4), 5, dtype=torch.int8), torch.ones(6), ValueError),  # code >= q
        (torch.zeros((6, 4), dtype=torch.float32), torch.ones(6), TypeError),  # float codes
        (torch.zeros((6, 4), dtype=torch.int8), torch.ones(5), ValueError),  # weights shape
        (torch.zeros((6, 4), dtype=torch.int8), torch.ones(6, dtype=torch.float16), TypeError),
    ],
    ids=["code_range", "float_codes", "weights_shape", "weights_dtype"],
)
def test_weighted_gram_bad_inputs_raise(codes, weights, err):
    with pytest.raises(err):
        ck.weighted_gram(codes, weights, 5)


def test_weighted_gram_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("weighted_gram")
