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
from pydca_tpu_torch.synthetic import planted_family

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


def _split_cases():
    rng = np.random.default_rng(11)
    n = 10**6
    below_pow2 = [np.nextafter(np.float32(2.0**-e), np.float32(0)) for e in range(0, 21)]
    return {
        "random": rng.uniform(1.0 / n, 1.0, size=4096),
        "reciprocals": 1.0 / np.array([1, 2, 3, 7, 11, 999, 1000, 4097, 65537, 999983, 10**6]),
        "edges": np.array([1.0, 1.0 / n, 3 * 2.0**-24, *below_pow2]),
    }


@pytest.mark.parametrize("case", ["random", "reciprocals", "edges"])
def test_bf16_split_is_exact(case):
    w = torch.tensor(_split_cases()[case].astype(np.float32))
    pieces = ck._bf16_split(w)
    assert pieces.dtype == torch.bfloat16 and pieces.shape == (3, w.numel())
    p = pieces.float()
    # every partial sum is a float32, so the order does not matter
    assert torch.equal((p[0] + p[1]) + p[2], w)
    assert torch.equal(p[0] + (p[1] + p[2]), w)
    np.testing.assert_array_equal(p.double().sum(0).numpy(), w.double().numpy())


@pytest.mark.parametrize("n,l,q", SHAPES)
def test_three_piece_product_equals_jax(n, l, q):
    """The kernel's arithmetic on the CPU: three bf16 weight pieces against
    the 0/1 one-hot, products exact, sums in float32."""
    msa, w = family(n, l, q, seed=n + l + q)
    w32 = w.astype(np.float32)
    x = torch.nn.functional.one_hot(torch.tensor(msa).long(), q).float().reshape(n, l * q)
    pieces = ck._bf16_split(torch.tensor(w32)).float()
    got = sum(x.T @ (x * piece[:, None]) for piece in pieces).numpy()
    onehot = np.eye(q, dtype=np.float32)[msa].reshape(n, l * q)
    pallas = pk.weighted_gram(
        jnp.asarray(onehot), jnp.asarray(w32), block_n=16, block_k=128, interpret=True
    )
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-6, atol=0)


GRAM_REL_F64 = 2e-6  # chip_smoke.py's limit on the card's float32 Gram vs float64


def _staged_pieces_gram(x, pieces):
    """The kernel's order: per 64-sequence stage, the pieces' products
    summed afresh, then added into a float32 total."""
    total = torch.zeros(x.shape[1], x.shape[1])
    for s in range(0, x.shape[0], 64):
        xs = x[s : s + 64]
        total += sum(xs.T @ (xs * piece[s : s + 64, None]) for piece in pieces)
    return total


@pytest.mark.parametrize("n,l,q", [(2704, 102, 5), (1000, 97, 21)])
def test_float64_limit_sees_a_missing_piece(n, l, q):
    """GRAM_REL_F64 holds the three pieces and rejects the first two alone
    (each weight then off by up to 2^-17 of itself), on the data of
    chip_smoke.py's phase 5."""
    codes = torch.tensor(planted_family(n, l, q, seed=n + l, n_pairs=0)[0])
    w = torch.tensor(np.random.default_rng(n).uniform(0.05, 1.0, n), dtype=torch.float32)
    x = torch.nn.functional.one_hot(codes.long(), q).float().reshape(n, l * q)
    pieces = ck._bf16_split(w).float()
    want = ck.weighted_gram_reference(codes, w.double(), q)
    nz = want != 0

    def rel(got):
        return float(((got.double() - want).abs()[nz] / want[nz]).max())

    assert rel(_staged_pieces_gram(x, pieces)) <= GRAM_REL_F64 / 2
    assert rel(_staged_pieces_gram(x, pieces[:2])) > 2 * GRAM_REL_F64


SM90 = 132  # streaming multiprocessors of an H100 SXM


@pytest.mark.parametrize(
    "n,k,splits",
    [
        (4096, 21000, 1),  # protein scale: 13695 tiles fill the card
        (2030, 4095, 1),  # PF02826 shape: 528 tiles
        (2704, 510, "many"),  # RF00167 shape: 10 tiles
        (2000, 130, "many"),  # K = 130: 3 tiles, one ragged
    ],
)
def test_gram_plan_splits(n, k, splits):
    s, chunk, ws = ck._gram_plan(n, k, SM90)
    if splits == 1:
        assert s == 1 and ws == 0
    else:
        assert s > 1
        side = -(-k // 128)  # 128 x 128 tiles on and above the diagonal
        assert ws == s * side * (side + 1) // 2 * 128 * 128 * 4


@pytest.mark.parametrize(
    "n,k,itemsize,plan",
    [
        (2704, 510, 4, (11, 256)),  # 10 tiles: 14 wanted, 43 stages in 11 chunks of 4
        (2000, 130, 4, (32, 64)),  # 3 tiles: one chunk per stage
        (1000, 2037, 4, (1, 1024)),  # 136 tiles fill the 132 SMs
        (300, 1281, 8, (2, 192)),  # 66 tiles: 2 wanted, 5 stages in 2 chunks of 3
        (4096, 21000, 4, (1, 4096)),
    ],
)
def test_gram_plan_follows_the_rule(n, k, itemsize, plan):
    # one wave of one block per SM, whole stages, no empty chunk
    assert ck._gram_plan(n, k, SM90, itemsize)[:2] == plan


@pytest.mark.parametrize(
    "n,k,itemsize",
    [(1, 15, 4), (30, 130, 4), (63, 130, 4), (64, 130, 4), (65, 510, 4), (130, 130, 4),
     (300, 1281, 8), (2704, 510, 8), (10**5, 120 * 5, 4), (4096, 21000, 4), (0, 15, 4)],
)
def test_gram_plan_chunks_cover_n_and_respect_cap(n, k, itemsize):
    s, chunk, ws = ck._gram_plan(n, k, SM90, itemsize)
    assert chunk % 64 == 0 and chunk > 0
    assert s * chunk >= n  # every sequence in a chunk
    if n:
        assert (s - 1) * chunk < n  # no empty chunk, even when N < splits x stage
    assert ws <= max(k * k * itemsize, 64 << 20)
    assert (s > 1) == (ws > 0)
