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


# the fused plmDCA step's passes (csrc/plm_passes.cu) against their plain
# composition on the card: the updated logits and picks within 2 float32
# ulps (the same operations), the cotangent within 10 ulps at 1 of the terms
# it is made of (the softmax sum of q <= 21 positive terms taken in another
# order: at most q - 1 roundings of half an ulp apart), the sums within 1e-6
# of the sum of their terms' magnitudes (float32 sums in another order: a
# tree of a few dozen levels against the library's)
EPS32 = 2.0 ** -23  # a float32 ulp at 1


def _assert_ulps(got, want, scale, k=4):
    err = (got.double() - want.double()).abs()
    bound = k * EPS32 * scale.double() + 1e-37
    assert bool((err <= bound).all()), f"{float((err / bound).max()):.3g} x {k} ulps"


def _plm_problem(n, l, q, seed, device):
    from pydca_tpu_torch import plm

    codes = torch.tensor(planted_family(n, l, q, seed=seed, n_pairs=4)[0], device=device)
    _, codes = plm._fused_inputs(codes, l, q)
    rng = np.random.default_rng(seed)

    def f32(*shape, scale):
        return torch.tensor(rng.normal(scale=scale, size=shape), dtype=torch.float32,
                            device=device)

    logits = f32(n, q, l, scale=2.0)
    return dict(logits=logits, picked=plm._picked(logits, plm._pick_mask(codes, q)),
                u=f32(n, q, l, scale=0.5), dh=f32(l, q, scale=0.3), codes=codes,
                weights=torch.tensor(rng.uniform(0.05, 1.0, n), dtype=torch.float32,
                                     device=device))


def _trial_term_sizes(p, alpha):
    """sum |w (lse - pk)| and sum |w (E[u'] - u'_pk)| in float64."""
    d = {k: v.double() if v.is_floating_point() else v for k, v in p.items()}
    up = d["u"] + d["dh"].T[None]
    from pydca_tpu_torch import plm

    mask = plm._pick_mask(d["codes"], up.shape[1])
    upk = torch.where(mask, up, 0.0).sum(1)
    t = d["logits"] + alpha * up
    lse = torch.logsumexp(t, 1)
    su = (torch.softmax(t, 1) * up).sum(1)
    w = d["weights"][:, None]
    return ((w * (lse - d["picked"] - alpha * upk)).abs().sum(),
            (w * (su - upk)).abs().sum())


# the two alphabets' q; past L = 256 a row takes several column blocks (the
# trial's sums over them, the update's direct path)
PLM_SHAPES = [(1000, 195, 21), (4097, 195, 21), (1000, 117, 21), (4097, 117, 5),
              (1000, 195, 5), (4097, 195, 5), (1000, 117, 5), (4097, 117, 21),
              (1000, 300, 21), (1000, 257, 5), (1000, 513, 21)]


@pytest.mark.gpu
@pytest.mark.parametrize("alpha", [0.0, 0.37])
@pytest.mark.parametrize("n,l,q", PLM_SHAPES)
def test_plm_trial_kernel_equals_plain(cuda, n, l, q, alpha):
    p = _plm_problem(n, l, q, seed=n + l + q, device=cuda)
    args = (p["logits"], p["codes"], p["weights"], p["picked"], p["u"], p["dh"], alpha)
    before = ck.plm_trial.launches
    got = ck.plm_trial(*args)
    assert ck.plm_trial.launches == before + 1
    want = ck.plm_trial_reference(*args)
    sizes = torch.stack(_trial_term_sizes(p, alpha)).float()
    assert bool(((got - want).abs() <= 1e-6 * sizes).all()), (got, want, sizes)


@pytest.mark.gpu
@pytest.mark.parametrize("step", ["no_u", "alpha_0", "alpha"])
@pytest.mark.parametrize("n,l,q", PLM_SHAPES)
def test_plm_update_grad_kernel_equals_plain(cuda, n, l, q, step):
    p = _plm_problem(n, l, q, seed=2 * n + l + q, device=cuda)
    alpha = 0.61 if step == "alpha" else 0.0
    extra = () if step == "no_u" else (p["u"], p["dh"], alpha)
    lg, pk = p["logits"].clone(), p["picked"].clone()
    before = ck.plm_update_grad.launches
    ct, gh = ck.plm_update_grad(lg, p["codes"], p["weights"], pk, *extra)
    assert ck.plm_update_grad.launches == before + 1
    lg_t, pk_t = p["logits"].clone(), p["picked"].clone()
    ct_t, gh_t = ck.plm_update_grad_reference(lg_t, p["codes"], p["weights"], pk_t, *extra)
    _assert_ulps(lg, lg_t, lg_t.abs(), k=2)
    _assert_ulps(pk, pk_t, pk_t.abs(), k=2)
    if step == "no_u":
        assert torch.equal(lg, p["logits"]) and torch.equal(pk, p["picked"])
    # ct = w (p - onehot): ulps of the softmax term and the one it loses
    _assert_ulps(ct, ct_t, ct_t.abs() + p["weights"][:, None, None], k=10)
    assert bool(((gh - gh_t).abs() <= 1e-6 * ct_t.abs().sum(0)).all())


@pytest.mark.gpu
def test_plm_passes_repeat_to_the_bit(cuda):
    p = _plm_problem(16384, 195, 21, seed=5, device=cuda)
    args = (p["codes"], p["weights"], p["picked"], p["u"], p["dh"])
    t1 = ck.plm_trial(p["logits"], *args, 0.21)
    t2 = ck.plm_trial(p["logits"], *args, 0.21)
    assert torch.equal(t1, t2)
    runs = []
    for _ in range(2):
        lg, pk = p["logits"].clone(), p["picked"].clone()
        ct, gh = ck.plm_update_grad(lg, p["codes"], p["weights"], pk, p["u"], p["dh"], 0.21)
        runs.append((lg, pk, ct, gh))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
def test_plm_passes_refuse_wide_alphabets_on_card(cuda):
    p = _plm_problem(64, 20, 5, seed=1, device=cuda)
    for q in (9, 33):
        other = torch.zeros(64, q, 20, device=cuda)
        with pytest.raises(ValueError, match="q must be one of"):
            ck.plm_update_grad(other, p["codes"], p["weights"])
    with pytest.raises(TypeError, match="uint8"):
        ck.plm_update_grad(p["logits"], p["codes"].long(), p["weights"])


@pytest.mark.gpu
def test_fused_fit_launches_one_pass_a_trial_and_a_gradient(cuda):
    """One fused fit on the card: ``plm_trial`` once a line-search trial
    (a first trial queued ahead and thrown away included),
    ``plm_update_grad`` once for the start and once a step; the fit's
    objective within 1e-4 of the CPU's (two float32 paths part after some
    twenty iterations, along directions in which the objective is flat)."""
    res, (trials, grads), cpu = _card_and_cpu_fits(cuda, 1500, 60, 21, 30, seed=11)
    assert res.num_iters > 5
    assert trials == res.n_evals - 1 + res.discarded_trials
    assert grads == res.num_iters + 1
    assert abs(res.fx - cpu.fx) <= 1e-4 * abs(cpu.fx)


@pytest.mark.gpu
def test_plm_trial_on_two_streams(cuda):
    """Each stream takes its own ticket: trials on a side stream and on the
    current one give the same sums."""
    p = _plm_problem(4097, 195, 21, seed=7, device=cuda)
    args = (p["logits"], p["codes"], p["weights"], p["picked"], p["u"], p["dh"], 0.4)
    here = ck.plm_trial(*args)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        there = ck.plm_trial(*args)
    torch.cuda.current_stream(cuda).wait_stream(side)
    assert torch.equal(here, there)
    assert ck._plm_ticket(cuda.index or 0, side.cuda_stream) is not ck._plm_ticket(
        cuda.index or 0, torch.cuda.current_stream(cuda).cuda_stream)


def _card_and_cpu_fits(cuda, n, l, q, iters, seed, **kw):
    from pydca_tpu_torch.plm import fit_plm

    codes = torch.tensor(planted_family(n, l, q, seed=seed, n_pairs=8)[0])
    w = stats.sequence_weights(codes, 0.8, q)
    lam = 0.2 * (l - 1)
    before = (ck.plm_trial.launches, ck.plm_update_grad.launches)
    res = fit_plm(codes.to(cuda), w.to(cuda), lam, lam, l, q, max_iterations=iters, **kw)
    launches = (ck.plm_trial.launches - before[0], ck.plm_update_grad.launches - before[1])
    return res, launches, fit_plm(codes, w, lam, lam, l, q, max_iterations=iters, **kw)


@pytest.mark.gpu
def test_fused_fit_past_one_column_block(cuda):
    """A fused fit at L = 300 (two column blocks a row: the update's direct
    path) on the card against the CPU: the launches as at L <= 256, the
    objective within 1e-4 (as at L = 60)."""
    res, (trials, grads), cpu = _card_and_cpu_fits(cuda, 800, 300, 21, 20, seed=12)
    assert res.num_iters > 5
    assert trials == res.n_evals - 1 + res.discarded_trials and grads == res.num_iters + 1
    assert abs(res.fx - cpu.fx) <= 1e-4 * abs(cpu.fx)


@pytest.mark.gpu
def test_fused_fit_bf16_products_runs_the_passes(cuda):
    """``--precision bfloat16``'s fused fit on the card: the logits stay
    float32 and run through the same two passes (once a trial, once a
    gradient); its objective within 1e-4 of the CPU's bf16 fit after 10
    iterations, before two float32 paths part."""
    res, (trials, grads), cpu = _card_and_cpu_fits(cuda, 1500, 60, 21, 10, seed=13,
                                                   mm_bf16=True)
    assert res.num_iters > 5
    assert trials == res.n_evals - 1 + res.discarded_trials and grads == res.num_iters + 1
    assert abs(res.fx - cpu.fx) <= 1e-4 * abs(cpu.fx)


def _history(k, m=5, dsz=200, seed=5):
    """``(zg, zzt, gg)`` of a circular history after ``k`` steps, float32 CPU."""
    rng = np.random.default_rng(seed + k)
    z = np.zeros((2 * m, dsz))
    for t in range(max(0, k - m), k):
        s = rng.normal(size=dsz)
        z[t % m], z[t % m + m] = s, s * rng.uniform(0.5, 2.0) + 0.1 * rng.normal(size=dsz)
    g = rng.normal(size=dsz)
    return (torch.tensor((z @ g).astype(np.float32)), torch.tensor((z @ z.T).astype(np.float32)),
            torch.tensor(np.float32(g @ g)))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [0, 1, 3, 4, 5, 8, 13, 22])
def test_direction_coeffs_on_card_match_cpu(cuda, k):
    """The direction's coefficients on card tensors (one launch of one
    thread, no host synchronisation) against the same on CPU tensors
    (LAPACK's solves) within float32 round-off."""
    from pydca_tpu_torch.ops import lbfgs as tl

    zg, zzt, gg = _history(k)
    want = tl.direction_coeffs(zg, zzt, gg, k, 5)
    on_card = [t.to(cuda) for t in (zg, zzt, gg)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tl.direction_coeffs(*on_card, k, 5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for name, a, b in zip(("gamma", "cfull", "dg0", "dnorm2"), got, want):
        assert a.device.type == "cuda"
        scale = float(b.abs().max()) or 1.0
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-5, atol=1e-6 * scale,
                                   err_msg=f"{name}, k={k}")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["step", "fallback", "no_update", "wrapped", "bf16_step",
                                  "bf16_wrapped", "bf16_no_update"])
def test_history_kernels_match_the_reference_on_card(cuda, case):
    """The history's new rows and Gram border by the kernels (one pass
    for the rows, one thread for the border: ``ck.lbfgs_history``, one
    launch of each) against the torch composition on the same card tensors
    (``ck.lbfgs_history_reference``): the rows to the bit, float32 or
    rounded to bfloat16, the Gram and the projections within float32
    round-off; a step whose s.y is not above 1e-10 leaves the rows and the
    Gram as they were."""
    from pydca_tpu_torch.ops import lbfgs as tl

    m, dim = 5, 4099
    k = 13 if case.endswith("wrapped") else 3
    gen = torch.Generator().manual_seed(k)
    z = torch.zeros(2 * m, dim)
    for t in range(max(0, k - m), k):
        s = torch.randn(dim, generator=gen)
        z[t % m], z[t % m + m] = s, 1.3 * s + 0.1 * torch.randn(dim, generator=gen)
    g, g_new = torch.randn(dim, generator=gen), torch.randn(dim, generator=gen)
    if case.startswith("bf16"):
        z = z.to(torch.bfloat16)
    z, g, g_new = z.to(cuda), g.to(cuda), g_new.to(cuda)
    gg = np.float32(float(torch.dot(g, g)))
    zg, zzt = ck._hist_dot(z, g), z.float() @ z.float().T
    gamma, cfull, dg0_t, _ = tl.direction_coeffs(zg.cpu(), zzt.cpu(), gg, k, m)
    d = -(float(gamma) * g + cfull.to(cuda) @ z.float())
    coeffs = (gamma.to(cuda), cfull.to(cuda))
    if case == "fallback":
        d, coeffs = -g, None
    dg0 = np.float32(float(torch.dot(g, d)))
    alpha = np.float32(1e-20 if case.endswith("no_update") else 0.7)
    dnorm2 = np.float32(float(torch.dot(d, d)))

    def run(fn):
        zc = z.clone()
        return (zc, *fn(zc, zzt.clone(), zg.clone(), g, d, g_new, k, alpha, dg0, dnorm2, gg,
                        coeffs))

    launches = ck.lbfgs_history.launches
    got = run(ck.lbfgs_history)
    assert ck.lbfgs_history.launches == launches + 1
    want = run(ck.lbfgs_history_reference)
    assert got[0].dtype == z.dtype and torch.equal(got[0], want[0])
    if case.endswith("no_update"):
        assert torch.equal(got[0], z) and torch.equal(got[1], zzt)
    else:
        assert not torch.equal(got[0], z)
    scale = float(want[1].abs().max())
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6 * scale)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6 * float(want[2].abs().max()))
    torch.testing.assert_close(got[3], want[3], rtol=1e-6, atol=0)


@pytest.mark.gpu
def test_fused_steps_launch_without_host_syncs_between_reads(cuda, monkeypatch):
    """Between two reads of a fused fit on the card the host waits for
    nothing: with ``torch.cuda.set_sync_debug_mode("error")`` every
    launch of twelve steps passes (the reads alone lift the mode), and the
    steps read once each, once for each trial after a step's first, and
    twice more for the call's first step; the steps' iterate equals the
    same steps read one value set at a time within float32 round-off."""
    from pydca_tpu_torch import plm as tplm
    from pydca_tpu_torch.ops import lbfgs as tl

    n, l, q = 1500, 60, 21
    codes = torch.tensor(planted_family(n, l, q, seed=11, n_pairs=8)[0], device=cuda)
    w = stats.sequence_weights(codes, 0.8, q).to(cuda)
    lam = 0.2 * (l - 1)
    x1h, codes8 = tplm._fused_inputs(codes, l, q)

    def fit(calls):
        st = tplm._plm_fused_state0(codes, w, lam, lam, l, q, 5)
        for steps in calls:
            tplm._plm_fused_steps(st, x1h, codes8, w, lam, lam, l, q, steps)
        return st

    ones = fit([1] * 13)
    st = fit([1])  # the first step builds the solver's and the passes' handles
    syncs, evals = st.host_syncs, st.n_evals
    real = tl._read_f32

    def reading(*vals):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real(*vals)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(tl, "_read_f32", reading)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tplm._plm_fused_steps(st, x1h, codes8, w, lam, lam, l, q, 12)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert st.k == 13 and not st.done and st.discarded_trials == 0
    assert st.host_syncs - syncs == st.n_evals - evals + 2
    assert st.n_evals == ones.n_evals
    assert float((st.x - ones.x).norm() / ones.x.norm()) <= 1e-5
