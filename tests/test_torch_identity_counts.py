"""Port's identity counts and sequence weights vs the JAX package, exactly.

The port runs its plain PyTorch version on the CPU; the JAX side runs the
Pallas kernel in interpret mode and the blocked XLA scan.  Integer
neighbour counts and the 1/m weights must be equal element for element.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pydca_tpu import stats as jstats
from pydca_tpu.ops import pallas_kernels as pk
from pydca_tpu_torch import stats as tstats
from pydca_tpu_torch.ops import _build
from pydca_tpu_torch.ops import cuda_kernels as ck


def clustered_msa(n, l, q, seed, mut=0.2):
    """A few ancestors plus point mutations: many pairs near the threshold."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, q, size=(5, l))
    msa = base[rng.integers(0, 5, size=n)]
    hit = rng.random((n, l)) < mut
    return np.where(hit, rng.integers(0, q, size=(n, l)), msa).astype(np.int32)


def jax_counts(msa, thr, q, block, valid=None):
    pallas = pk.identity_counts(
        jnp.asarray(msa), thr, q, block=block, interpret=True,
        valid=None if valid is None else jnp.asarray(valid),
    )
    if valid is None:
        scan = jstats._sequence_weights_impl(
            jnp.asarray(msa), jnp.float32(thr), q, block
        )
    else:
        scan = jstats._sequence_weights_impl(
            jnp.asarray(msa), jnp.float32(thr), q, block, jnp.asarray(valid),
            has_valid=True,
        )
    return np.asarray(pallas), np.asarray(scan)


@pytest.mark.parametrize(
    "n,l,q,block",
    [
        (64, 11, 5, 32),  # RNA alphabet, N a multiple of the block
        (64, 11, 21, 32),  # protein alphabet
        (70, 11, 5, 32),  # ragged N: last row block holds 6 rows
        (97, 37, 21, 32),  # ragged N and L
    ],
)
def test_identity_counts_equal_jax(n, l, q, block):
    msa = clustered_msa(n, l, q, seed=n + l + q)
    thr = 0.8 * l
    got = ck.identity_counts(torch.tensor(msa), thr, q, block=block).numpy()
    pallas, scan = jax_counts(msa, thr, q, block)
    # integer counts: exact equality, no tolerance
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, scan)
    assert got.max() > 1  # the family has neighbours above the threshold


def test_identity_counts_valid_mask_equal_jax():
    rng = np.random.default_rng(11)
    n, l, q = 70, 13, 5
    msa = clustered_msa(n, l, q, seed=3)
    valid = rng.random(n) > 0.3
    thr = 0.5 * l
    got = ck.identity_counts(
        torch.tensor(msa), thr, q, valid=torch.tensor(valid), block=32
    ).numpy()
    pallas, scan = jax_counts(msa, thr, q, 32, valid=valid)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, scan)
    ident = (msa[:, None, :] == msa[None, :, :]).sum(-1)
    np.testing.assert_array_equal(got, ((ident > thr) & valid[None, :]).sum(1))


def edge_msa():
    """L = 100 rows where many pairs share exactly 57 positions."""
    rng = np.random.default_rng(5)
    l, q = 100, 5
    base = rng.integers(0, q, size=l)
    rows = [base]
    for _ in range(40):
        row = base.copy()
        flip = rng.choice(l, size=43, replace=False)
        row[flip] = (row[flip] + rng.integers(1, q, size=43)) % q
        rows.append(row)
    return np.stack(rows).astype(np.int32), q


def test_f32_threshold_edge_equal_jax():
    """seqid 0.57, L 100: 0.57*100 is 56.99999999999999 in float64 but 57.0
    in float32; a pair with 57 matches passes the first, fails the second."""
    msa, q = edge_msa()
    n, l = msa.shape
    seqid = 0.57
    assert seqid * l < 57.0 and np.float32(seqid * l) == 57.0
    ident = (msa[:, None, :] == msa[None, :, :]).sum(-1)
    assert (ident == 57).any()
    f32_counts = (ident > np.float32(seqid * l)).sum(1)
    f64_counts = (ident > seqid * l).sum(1)
    assert not np.array_equal(f32_counts, f64_counts)  # the edge is exercised

    got = tstats.sequence_weights(torch.tensor(msa), seqid, q).numpy()
    want = np.asarray(jstats.sequence_weights(jnp.asarray(msa), seqid, q))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, (1.0 / f32_counts).astype(np.float32))


@pytest.mark.parametrize("q", [5, 21])
def test_sequence_weights_equal_jax(q):
    msa = clustered_msa(150, 40, q, seed=q)
    got = tstats.sequence_weights(torch.tensor(msa), 0.8, q)
    want = np.asarray(jstats.sequence_weights(jnp.asarray(msa), 0.8, q))
    assert got.dtype == torch.float32
    # same integer counts and the same float32 division: bitwise equal
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 1).any()


def test_sequence_weights_masked_equal_jax():
    rng = np.random.default_rng(12)
    n, l, q = 64, 9, 5
    msa = clustered_msa(n, l, q, seed=12)
    valid = rng.random(n) > 0.25
    got = tstats.sequence_weights(
        torch.tensor(msa), 0.8, q, valid=torch.tensor(valid)
    ).numpy()
    want = np.asarray(
        jstats.sequence_weights(jnp.asarray(msa), 0.8, q, valid=jnp.asarray(valid))
    )
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bad", [-1, 5])
def test_codes_out_of_range_raise(bad):
    msa = clustered_msa(20, 8, 5, seed=1)
    msa[3, 4] = bad
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        ck.identity_counts(torch.tensor(msa), 6.0, 5)


def test_cpu_path_does_not_count_launches():
    before = ck.identity_counts.launches
    ck.identity_counts(torch.tensor(clustered_msa(10, 6, 5, seed=2)), 4.0, 5)
    assert ck.identity_counts.launches == before


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("identity_counts")


def test_library_name_tracks_source_and_flags(monkeypatch):
    path = _build.library_path("identity_counts")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libidentity_counts_")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("identity_counts") != path


@pytest.mark.parametrize(
    "codes,valid,err",
    [
        (torch.zeros(6, dtype=torch.int32), None, ValueError),  # not (N, L)
        (torch.zeros((6, 4), dtype=torch.float32), None, TypeError),  # not integer
        (torch.zeros((6, 4), dtype=torch.int8), torch.ones(5, dtype=torch.bool), ValueError),
    ],
    ids=["1d", "float", "valid_shape"],
)
def test_bad_inputs_raise(codes, valid, err):
    with pytest.raises(err):
        ck.identity_counts(codes, 2.0, 5, valid=valid)
