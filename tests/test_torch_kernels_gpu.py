"""CUDA kernels of the port against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA card (a CUDA kernel has no
CPU mode; the CPU tests hold the plain versions against the JAX package).
Imports only torch and the port, so it runs where JAX is not installed
(``--noconftest`` skips ``tests/conftest.py``, which imports JAX):

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from pydca_tpu_torch import stats
from pydca_tpu_torch.device import set_precision
from pydca_tpu_torch.meanfield import MeanFieldDCA
from pydca_tpu_torch.ops import cuda_kernels as ck
from pydca_tpu_torch.synthetic import planted_family, spearman, top_k_overlap


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    set_precision()
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "n,l,q",
    [
        (1, 3, 5),
        (65, 64, 5),
        (128, 128, 5),  # one full tile, one full position block
        (129, 129, 21),  # a second row tile and position block, one row/position each
        (257, 1000, 21),  # three row tiles, protein length
        (1000, 97, 21),
        (2704, 102, 5),
    ],
)
def test_identity_counts_kernel_equals_plain(cuda, n, l, q):
    codes = torch.tensor(planted_family(n, l, q, seed=n, n_pairs=0)[0], device=cuda)
    # about a fifth of the rows invalid, in every row tile
    valid = torch.tensor(np.random.default_rng(n).random(n) > 0.2, device=cuda)
    npad, lpad, _ = ck._identity_plan(n, l)  # the scratch the launcher pads into
    assert ck._identity_counts_lib().identity_counts_scratch_bytes(n, l) == npad * lpad
    for v in (None, valid):
        before = ck.identity_counts.launches
        got = ck.identity_counts(codes, 0.8 * l, q, valid=v)
        want = ck.identity_counts_reference(codes, 0.8 * l, q, valid=v)
        again = ck.identity_counts(codes, 0.8 * l, q, valid=v)
        torch.cuda.synchronize()
        assert torch.equal(got, want)  # integer counts: exact
        assert torch.equal(got, again)  # integer atomics: the same in every run
        assert ck.identity_counts.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("n,l,q", [(257, 1000, 21), (1000, 97, 21), (2704, 102, 5)])
def test_identity_counts_tile_ranges_equal_plain(cuda, n, l, q):
    """A launch over a range of the upper-triangle tiles adds exactly the
    plain partial counts of those tiles; the ranks' shares sum to the full
    counts."""
    codes = torch.tensor(planted_family(n, l, q, seed=n, n_pairs=0)[0], device=cuda)
    valid = torch.tensor(np.random.default_rng(n).random(n) > 0.2, device=cuda)
    for v in (None, valid):
        full = ck.identity_counts(codes, 0.8 * l, q, valid=v)
        for world in (2, 3):
            total = torch.zeros_like(full)
            for r in range(world):
                tiles = ck.identity_tile_share(n, r, world)
                got = ck.identity_counts(codes, 0.8 * l, q, valid=v, tiles=tiles)
                want = ck.identity_counts_reference(codes, 0.8 * l, q, valid=v, tiles=tiles)
                torch.cuda.synchronize()
                assert torch.equal(got, want)
                total += got
            assert torch.equal(total, full)


@pytest.mark.gpu
def test_apc_on_card_is_repeatable(cuda):
    """APC at L = 1000 gives the same bits in every run on the card (its
    site sums were an ``index_add_`` of floats, whose atomics add in the
    order they land) and equals the CPU's to float32 round-off."""
    from pydca_tpu_torch import score

    l = 1000
    s = torch.tensor(np.random.default_rng(0).random(l * (l - 1) // 2).astype(np.float32))
    runs = [score.apc(s.to(cuda), l) for _ in range(5)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    torch.testing.assert_close(runs[0].cpu(), score.apc(s, l), rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_one_rank_mesh_on_card_equals_one_device(cuda):
    """A mesh of one process (no group): the sharded weights, fit and
    mean-field scores equal the one-device engines' bitwise."""
    from pydca_tpu_torch import alphabets
    from pydca_tpu_torch.io.fasta import MSA
    from pydca_tpu_torch.parallel import make_mesh
    from pydca_tpu_torch.plm import PlmDCA

    codes = planted_family(1000, 40, 21, seed=3, n_pairs=4)[0]
    msa = MSA(data=codes, alphabet=alphabets.PROTEIN)
    mesh = make_mesh(device=cuda)
    runs = [PlmDCA(msa, "protein", max_iterations=15, device=cuda, mesh=m) for m in (None, mesh)]
    assert torch.equal(runs[0].compute_seqs_weight(), runs[1].compute_seqs_weight())
    assert np.array_equal(*(r.get_fields_and_couplings_from_backend() for r in runs))
    mfs = [MeanFieldDCA(msa, "protein", device=cuda, mesh=m) for m in (None, mesh)]
    assert mfs[0].compute_sorted_FN_APC() == mfs[1].compute_sorted_FN_APC()


@pytest.mark.gpu
def test_identity_counts_too_long_raises_on_card(cuda):
    # a match adds 2^14 to an s32 accumulator: L < 2^17
    codes = torch.zeros((2, 1 << 17), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="limits"):
        ck.identity_counts(codes, 1.0, 5)


@pytest.mark.gpu
def test_sequence_weights_cuda_equal_cpu(cuda):
    codes = torch.tensor(planted_family(2000, 60, 21, seed=3, n_pairs=0)[0])
    w_cpu = stats.sequence_weights(codes, 0.8, 21)
    w_gpu = stats.sequence_weights(codes.to(cuda), 0.8, 21)
    assert torch.equal(w_cpu, w_gpu.cpu())


@pytest.mark.gpu
def test_out_of_range_codes_raise_on_card(cuda):
    codes = torch.full((8, 5), 5, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        ck.identity_counts(codes, 4.0, 5)


GRAM_CASES = [
    (1, 3, 5, torch.float32),  # N = 1
    (30, 26, 5, torch.float32),  # N smaller than one 64-sequence stage
    (130, 26, 5, torch.float32),  # K = 130: one full tile and a ragged one
    (2000, 26, 5, torch.float32),  # K = 130 with split-N
    (1000, 97, 21, torch.float32),
    (2704, 102, 5, torch.float32),  # RF00167 shape, split-N
    (300, 61, 21, torch.float64),  # float64, split-N
    (2704, 102, 5, torch.float64),  # float64, split-N over 11 chunks
]
SPLIT_CASES = [GRAM_CASES[i] for i in (3, 5, 6, 7)]  # the cases marked split-N


@pytest.mark.gpu
@pytest.mark.parametrize("n,l,q,dtype", GRAM_CASES)
def test_weighted_gram_kernel_equals_plain(cuda, n, l, q, dtype):
    codes = torch.tensor(planted_family(n, l, q, seed=n, n_pairs=0)[0], device=cuda)
    w = torch.tensor(np.random.default_rng(n).uniform(0.05, 1.0, n), dtype=dtype, device=cuda)
    before = ck.weighted_gram.launches
    got = ck.weighted_gram(codes, w, q)
    want = ck.weighted_gram_reference(codes, w, q)
    torch.cuda.synchronize()
    assert ck.weighted_gram.launches == before + 1
    assert got.dtype == dtype and got.shape == (l * q, l * q)
    # no atomics, sums in a fixed order: the same bits in every run
    assert torch.equal(got, ck.weighted_gram(codes, w, q))
    # sums of non-negative terms: zero exactly where there are no terms
    assert torch.equal(got == 0, want == 0)
    assert torch.equal(got, got.T)
    meff = w.sum()
    rtol, atol = (1e-5, 1e-6) if dtype == torch.float32 else (1e-12, 1e-15)
    torch.testing.assert_close(got / meff, want / meff, rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("n,l,q", [(2704, 102, 5), (2030, 195, 21)])
def test_weighted_gram_f32_close_to_float64(cuda, n, l, q):
    # exact fp32 from three bf16 pieces: ~4e-7 of float64 on the same
    # weights, as cuBLAS fp32; two pieces alone give ~7e-6
    codes = torch.tensor(planted_family(n, l, q, seed=n + l, n_pairs=0)[0], device=cuda)
    w = torch.tensor(np.random.default_rng(n).uniform(0.05, 1.0, n), dtype=torch.float32,
                     device=cuda)
    got = ck.weighted_gram(codes, w, q).double()
    want = ck.weighted_gram_reference(codes, w.double(), q)
    nz = want != 0
    assert float(((got - want).abs()[nz] / want[nz]).max()) <= 2e-6


@pytest.mark.gpu
@pytest.mark.parametrize("n,l,q,dtype", SPLIT_CASES)
def test_weighted_gram_split_n_is_active(cuda, n, l, q, dtype):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert ck._gram_plan(n, l * q, sms, itemsize)[0] > 1


@pytest.mark.gpu
def test_weighted_gram_out_of_range_codes_raise_on_card(cuda):
    codes = torch.full((8, 5), 5, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        ck.weighted_gram(codes, torch.ones(8, device=cuda), 5)


@pytest.mark.gpu
def test_weighted_gram_wide_codes_out_of_range_raise_on_card(cuda):
    # 261 would wrap to a valid int8 code: checked before the cast
    codes = torch.full((8, 5), 261, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ck.weighted_gram(codes, torch.ones(8, device=cuda), 5)


@pytest.mark.gpu
def test_meanfield_cuda_equals_cpu(cuda):
    codes = planted_family(1500, 80, 21, seed=4, n_pairs=8)[0]
    runs = {}
    for device in ("cpu", "cuda"):
        inst = MeanFieldDCA(codes, "protein", device=device)
        runs[device] = (inst.get_sequences_weight().cpu(), inst.compute_sorted_FN_APC())
    assert torch.equal(runs["cpu"][0], runs["cuda"][0])
    assert spearman(runs["cpu"][1], runs["cuda"][1], 80) >= 0.98
    assert top_k_overlap(runs["cpu"][1], runs["cuda"][1], 20) >= 0.9


@pytest.mark.gpu
def test_two_site_fixed_point_cuda_equals_cpu(cuda):
    from pydca_tpu_torch import score

    l, q = 60, 21
    rng = np.random.default_rng(6)
    blocks = torch.tensor(rng.normal(scale=0.5, size=(l * (l - 1) // 2, q - 1, q - 1)))
    fi = torch.tensor(0.5 / q + 0.5 * rng.dirichlet(np.full(q, 0.5), size=l))
    hi_c, hj_c, st_c = score.two_site_model_fields(blocks, fi, l, q, return_iters=True)
    hi_g, hj_g, st_g = score.two_site_model_fields(
        blocks.to(cuda), fi.to(cuda), l, q, return_iters=True
    )
    torch.testing.assert_close(hi_g.cpu(), hi_c, rtol=1e-10, atol=0)
    torch.testing.assert_close(hj_g.cpu(), hj_c, rtol=1e-10, atol=0)
    assert torch.equal(st_g.iters.cpu(), st_c.iters)
    di_c = score.direct_information(blocks, fi, l, q)
    di_g = score.direct_information(blocks.to(cuda), fi.to(cuda), l, q)
    torch.testing.assert_close(di_g.cpu(), di_c, rtol=1e-10, atol=1e-15)


@pytest.mark.gpu
def test_protein_scale_coupling_blocks_gather_memory(cuda):
    """L = 1000, q = 21: the (P, 20, 20) gather from the permuted view of
    the 20000^2 couplings holds at most couplings + 2 x blocks."""
    from pydca_tpu_torch.meanfield import _pair_blocks

    l, qm1 = 1000, 20
    couplings = torch.randn(l * qm1, l * qm1, device=cuda)
    p = l * (l - 1) // 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    blocks = _pair_blocks(couplings, l, qm1)
    torch.cuda.synchronize()
    block_bytes = p * qm1 * qm1 * 4
    assert torch.cuda.max_memory_allocated() <= base + 2 * block_bytes
    assert blocks.shape == (p, qm1, qm1)
    j4 = couplings.reshape(l, qm1, l, qm1)
    iu, ju = np.triu_indices(l, k=1)
    for k in (0, 123456, p - 1):
        assert torch.equal(blocks[k], j4[iu[k], :, ju[k], :])


@pytest.mark.gpu
@pytest.mark.parametrize("block", [64, 250, 1000])
def test_streamed_loss_and_grad_cuda_equals_cpu(cuda, block):
    """The streamed objective on the card against the CPU: 16 blocks (the
    last one short), 4 equal blocks and one block of 1000 rows."""
    from pydca_tpu_torch import plm

    n, l, q = 1000, 40, 21
    codes = torch.tensor(planted_family(n, l, q, seed=8, n_pairs=4)[0])
    rng = np.random.default_rng(8)
    w = torch.tensor(rng.uniform(0.1, 1.0, n), dtype=torch.float32)
    theta = torch.tensor(rng.normal(scale=0.05, size=l * q + l * (l - 1) // 2 * q * q),
                         dtype=torch.float32)
    f_cpu, g_cpu = plm.plm_loss_and_grad_chunked(theta, codes, w, 7.8, 7.8, l, q, block)
    f_gpu, g_gpu = plm.plm_loss_and_grad_chunked(theta.to(cuda), codes.to(cuda), w.to(cuda),
                                                 7.8, 7.8, l, q, block)
    torch.testing.assert_close(f_gpu.cpu(), f_cpu, rtol=1e-5, atol=0)
    torch.testing.assert_close(g_gpu.cpu(), g_cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_streamed_fit_on_card_launches_identity_counts(cuda):
    """A small streamed fit through the engine on the card: the route, one
    launch of the CUDA identity_counts, and the ranking of the CPU's."""
    from pydca_tpu_torch.io.fasta import MSA
    from pydca_tpu_torch.alphabets import PROTEIN
    from pydca_tpu_torch.plm import PlmDCA

    codes = planted_family(1500, 60, 21, seed=9, n_pairs=8)[0]
    msa = MSA(data=codes, alphabet=PROTEIN)
    runs = {}
    for device in ("cpu", "cuda"):
        before = ck.identity_counts.launches
        inst = PlmDCA(msa, "protein", device=device, seq_block=512, max_iterations=40)
        runs[device] = inst.compute_sorted_FN_APC()
        assert inst.seq_block == 512
        assert ck.identity_counts.launches - before == (1 if device == "cuda" else 0)
    assert spearman(runs["cpu"], runs["cuda"], 60) >= 0.98
    assert top_k_overlap(runs["cpu"], runs["cuda"], 20) >= 0.9


@pytest.mark.gpu
@pytest.mark.parametrize("seqid", [0.8, 1.0])
def test_family_weights_launch_identity_counts_per_family(cuda, seqid):
    """Family weights on the card: one launch of the CUDA identity_counts
    per family, on each family's own rows and sites (the pad token never
    reaches the kernel), equal to the CPU's plain counts' weights."""
    from pydca_tpu_torch.alphabets import PROTEIN
    from pydca_tpu_torch.family import FamilyBatch, family_sequence_weights
    from pydca_tpu_torch.io.fasta import MSA

    shapes = [(300, 40), (1000, 97), (129, 129), (2500, 60)]
    batch = FamilyBatch([MSA(data=planted_family(n, l, 21, seed=n, n_pairs=2)[0],
                             alphabet=PROTEIN) for n, l in shapes])
    before = ck.identity_counts.launches
    got = family_sequence_weights(batch, seqid, device=cuda)
    assert ck.identity_counts.launches - before == len(shapes)
    want = family_sequence_weights(batch, seqid, device="cpu")
    assert ck.identity_counts.launches - before == len(shapes)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got.cpu() == 0, torch.from_numpy(~batch.seq_mask))


@pytest.mark.gpu
@pytest.mark.parametrize("seq_block", [None, 256], ids=["fused", "generic"])
def test_checkpoint_resume_on_card_is_bitwise(cuda, tmp_path, seq_block):
    """A fit interrupted at 10 iterations and resumed from its file equals
    the uninterrupted 20-iteration fit on the card, bit for bit."""
    from pydca_tpu_torch.plm import fit_plm

    codes = torch.tensor(planted_family(1200, 40, 21, seed=4, n_pairs=6)[0], device=cuda)
    w = stats.sequence_weights(codes, 0.8, 21)
    lam = 0.2 * 39

    def fit(iters, ckpt=None):
        return fit_plm(codes, w, lam, lam, 40, 21, max_iterations=iters, chunk_size=5,
                       checkpoint_path=ckpt, checkpoint_every=5, seq_block=seq_block)

    full = fit(20)
    ckpt = str(tmp_path / "state.npz")
    fit(10, ckpt)
    resumed = fit(20, ckpt)
    assert resumed.num_iters == full.num_iters
    assert torch.equal(resumed.x, full.x)


@pytest.mark.gpu
@pytest.mark.parametrize("bio", ["rna", "protein"])
def test_template_search_and_mapping_on_card_equal_cpu(cuda, bio):
    """The template search on the card gives the CPU's scores bit for bit
    (integer scores in float32), and a card backmapper the CPU's mapping."""
    from pydca_tpu_torch import align, matrices
    from pydca_tpu_torch.alphabets import get_alphabet
    from pydca_tpu_torch.backmap import SequenceBackmapper, templates_from_codes
    from pydca_tpu_torch.synthetic import reference_from_row

    alph = get_alphabet(bio)
    codes = planted_family(3000, 150, alph.q, seed=4, n_pairs=0)[0]
    ref = reference_from_row(codes, 1234, alph, seed=5, ends=(7, 9))
    sub = matrices.submatrix_for(bio, alph.letters)
    go, ge = matrices.gap_penalties_for(bio)
    temps = templates_from_codes(torch.from_numpy(codes), alph.gap_state)
    assert torch.equal(templates_from_codes(torch.from_numpy(codes).to(cuda), alph.gap_state).cpu(),
                       temps)
    args = (alph.encode_str(ref), temps, sub, go, ge, alph.gap_state)
    on_card = align.batch_local_align_scores(*args, device="cuda")
    np.testing.assert_array_equal(on_card, align.batch_local_align_scores(*args, device="cpu"))
    kw = dict(alignment_data=list(codes), ref_seq=ref, biomolecule=bio)
    got = SequenceBackmapper(device="cuda", **kw).map_to_reference_sequence()
    assert list(got.items()) == list(SequenceBackmapper(device="cpu", **kw).map_to_reference_sequence().items())


@pytest.mark.gpu
def test_blocked_solve_on_card_matches_torch_linalg(cuda):
    """The JAX package's solve on one card at D 4200 (above the 4096 where
    the mesh takes the blocked factor), float32: ``cholesky_blocked``
    (block 2048) against ``torch.linalg.cholesky``, ``tri_inv_lower``
    against ``solve_triangular``, ``spd_inverse(chol_block=2048)`` against
    ``torch.linalg.inv``, at rtol and atol 2e-4 (entries of order 1)."""
    from pydca_tpu_torch.ops import linalg

    d = 4200
    a = torch.randn(d, d, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    c = ((a @ a.T) / d + torch.eye(d, dtype=torch.float64)).to(torch.float32).to(cuda)
    tol = dict(rtol=2e-4, atol=2e-4)
    fac, info = linalg.cholesky_blocked(c, 2048)
    lower = torch.linalg.cholesky(c)
    assert int(info) == 0 and bool((torch.triu(fac, 1) == 0).all())
    torch.testing.assert_close(fac, lower, **tol)
    eye = torch.eye(d, dtype=c.dtype, device=cuda)
    torch.testing.assert_close(linalg.tri_inv_lower(lower),
                               torch.linalg.solve_triangular(lower, eye, upper=False), **tol)
    inv, info = linalg.spd_inverse(c, chol_block=2048)
    assert int(info) == 0
    torch.testing.assert_close(inv, torch.linalg.inv(c), **tol)
