"""Port's identity counts and sequence weights vs the JAX package, exactly.

The port runs its plain PyTorch version on the CPU; the JAX side runs the
Pallas kernel in interpret mode and the blocked XLA scan.  Integer
neighbour counts and the 1/m weights must be equal element for element.
A numpy twin of the CUDA kernel's decomposition (state planes, upper-
triangle tiles, row and column sums) is held to both as well.
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


# ------------------------------------------------ the CUDA kernel's arithmetic


def kernel_twin(msa, thr, q, valid=None):
    """``csrc/identity_counts.cu`` step by step in numpy.

    Pads the codes to (npad, lpad) with the pad byte, builds the q state
    planes 4 codes a word with the kernel's bit trick (0x80 where the code
    is the state), lays the contraction out state-major, walks the upper-
    triangle 128 x 128 tiles in the launcher's block order and takes the
    thresholded row sums, plus the column sums of off-diagonal tiles, each
    masked by ``valid`` on the other side.
    """
    n, l = msa.shape
    npad, lpad, tiles = ck._identity_plan(n, l)
    cp = np.full((npad, lpad), ck._IC_PAD, np.uint8)
    cp[:n, :l] = msa
    words = cp.view("<u4")
    planes = []
    for a in range(q):
        a4 = np.uint32(a * 0x01010101)
        z = ~((words ^ a4) + np.uint32(0x7F7F7F7F)) & np.uint32(0x80808080)
        plane = z.view(np.uint8)
        np.testing.assert_array_equal(plane, np.where(cp == a, 0x80, 0))
        planes.append(plane)
    x = np.concatenate(planes, axis=1).astype(np.float64)  # K = (state, position)
    keep = np.zeros(npad, bool)
    keep[:n] = True if valid is None else valid
    min_acc = ck._identity_min_acc(thr)
    out = np.zeros(npad, np.int64)
    seen = set()
    t_edge = ck._IC_TILE
    for t in range(tiles):
        ti, tj = ck._identity_tile_of(t)
        assert ti <= tj and (ti, tj) not in seen
        seen.add((ti, tj))
        rows = slice(t_edge * ti, t_edge * (ti + 1))
        cols = slice(t_edge * tj, t_edge * (tj + 1))
        acc = (x[rows] @ x[cols].T).astype(np.int64)  # exact: <= 2^14 * L
        assert acc.max() < 2**31 and not (acc % (1 << ck._IC_SHIFT)).any()
        ind = acc >= min_acc
        # the integer form of the threshold is the float32 compare
        np.testing.assert_array_equal(ind, (acc >> ck._IC_SHIFT).astype(np.float32) > np.float32(thr))
        out[rows] += (ind & keep[cols][None, :]).sum(1)
        if ti != tj:
            out[cols] += (ind & keep[rows][:, None]).sum(0)
    side = npad // t_edge
    assert len(seen) == side * (side + 1) // 2
    return out[:n].astype(np.int32)


TWIN_CASES = [
    (n, l, 5 if l in (102, 129) else 21)
    for n in (1, 127, 128, 129, 300)
    for l in (102, 128, 129, 195)
]


@pytest.mark.parametrize("n,l,q", TWIN_CASES)
def test_kernel_twin_equals_plain_and_jax(n, l, q):
    msa = clustered_msa(n, l, q, seed=n + l)
    thr = 0.6 * l  # near the family's typical identity of ~0.65
    twin = kernel_twin(msa, thr, q)
    np.testing.assert_array_equal(twin, ck.identity_counts_reference(torch.tensor(msa), thr, q))
    pallas = pk.identity_counts(jnp.asarray(msa), thr, q, interpret=True)
    np.testing.assert_array_equal(twin, np.asarray(pallas))
    if n > 1:
        assert twin.max() > 1  # neighbours above the threshold


def test_kernel_twin_valid_mask_both_tile_sides():
    # rows dropped in tile 0 and tile 2: column sums (tile 0 rows as the
    # neighbours of tile 2) and row sums both see the mask
    n, l, q = 300, 102, 5
    msa = clustered_msa(n, l, q, seed=21)
    valid = np.ones(n, bool)
    valid[[0, 5, 77, 127, 128, 200, 256, 299]] = False
    valid[np.random.default_rng(3).random(n) < 0.2] = False
    thr = 0.7 * l
    twin = kernel_twin(msa, thr, q, valid=valid)
    np.testing.assert_array_equal(
        twin, ck.identity_counts_reference(torch.tensor(msa), thr, q, valid=torch.tensor(valid))
    )
    pallas = pk.identity_counts(jnp.asarray(msa), thr, q, valid=jnp.asarray(valid), interpret=True)
    np.testing.assert_array_equal(twin, np.asarray(pallas))
    full = kernel_twin(msa, thr, q)
    assert (twin[:128] < full[:128]).any() and (twin[256:] < full[256:]).any()


def test_kernel_twin_f32_threshold_edge():
    """300 rows at 57 matches of 100 from a base row: over three tiles, and
    float32(0.57 * 100) = 57.0 rejects what 56.99... in float64 keeps."""
    rng = np.random.default_rng(5)
    l, q = 100, 5
    base = rng.integers(0, q, size=l)
    rows = [base]
    for _ in range(299):
        row = base.copy()
        flip = rng.choice(l, size=43, replace=False)
        row[flip] = (row[flip] + rng.integers(1, q, size=43)) % q
        rows.append(row)
    msa = np.stack(rows).astype(np.int32)
    ident = (msa[:, None, :] == msa[None, :, :]).sum(-1)
    thr = 0.57 * l
    f32_counts = (ident > np.float32(thr)).sum(1)
    assert not np.array_equal(f32_counts, (ident > thr).sum(1))
    twin = kernel_twin(msa, thr, q)
    np.testing.assert_array_equal(twin, f32_counts)
    pallas = pk.identity_counts(jnp.asarray(msa), thr, q, interpret=True)
    np.testing.assert_array_equal(twin, np.asarray(pallas))


def test_plane_bytes_have_no_carry():
    # every code in [0, 127) and the pad, in every byte lane, for every state
    codes = np.arange(128, dtype=np.uint8)
    codes[127] = ck._IC_PAD
    lanes = np.stack([np.roll(codes, s) for s in range(4)], axis=1)  # (128, 4)
    words = np.ascontiguousarray(lanes).view("<u4")[:, 0]
    for a in range(127):
        z = ~((words ^ np.uint32(a * 0x01010101)) + np.uint32(0x7F7F7F7F)) & np.uint32(
            0x80808080
        )
        got = z.astype("<u4").view(np.uint8).reshape(128, 4)
        np.testing.assert_array_equal(got, np.where(lanes == a, 0x80, 0))


@pytest.mark.parametrize("n", [1, 127, 128, 129, 300, 16384, 200000])
def test_identity_plan_and_tile_order(n):
    npad, lpad, tiles = ck._identity_plan(n, 195)
    side = -(-n // 128)
    assert npad == 128 * side and lpad == 256 and tiles == side * (side + 1) // 2
    for t in {0, 1, 2, tiles // 2, tiles - 1} & set(range(tiles)):
        ti, tj = ck._identity_tile_of(t)
        assert 0 <= ti <= tj < side and tj * (tj + 1) // 2 + ti == t


@pytest.mark.parametrize(
    "thr,want",
    [
        (57.0, 58 << 14),  # float32(0.57 * 100): 57 matches do not pass
        (0.57 * 100, 58 << 14),  # 56.99999999999999 rounds to 57.0 first
        (56.5, 57 << 14),
        (0.0, 1 << 14),
        (-0.5, 0),  # every count passes, 0 too
        (float("nan"), 0xFFFFFFFF),  # none does
        (float("inf"), 0xFFFFFFFF),
        (131071.0, 0xFFFFFFFF),  # past the longest L
        (131070.0, 131071 << 14),
    ],
)
def test_identity_min_acc(thr, want):
    got = ck._identity_min_acc(thr)
    assert got == want and 0 <= got <= 0xFFFFFFFF
    for m in [*range(200), *range(0, 131072, 4099), 131070, 131071]:  # as float32 says
        assert ((m << ck._IC_SHIFT) >= got) == bool(np.float32(m) > np.float32(thr))
