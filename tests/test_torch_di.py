"""Port's DI scoring vs ``pydca_tpu``: the two-site fixed point, DI, and the
engines' DI, fields and ``compute_params``, on the CPU.

Inputs are made from a numpy seed (or the committed fitted parameters) and
go through the JAX function and its port.  In float64 the fixed point's
fields and DI agree to rtol 1e-10 on every pair: a pair whose iteration
count were off by one would miss by about the 1e-4 tolerance, so this
shows the per-pair counts are equal.  Through the float64 mean-field
engine the bar is rtol 1e-8, as for its couplings.
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pydca_tpu import score as jscore
from pydca_tpu.alphabets import PROTEIN as JPROTEIN, RNA as JRNA
from pydca_tpu.backmap import SequenceBackmapper as JSequenceBackmapper
from pydca_tpu.io.fasta import MSA as JMSA
from pydca_tpu.plm import PlmDCA as JPlmDCA
from pydca_tpu_torch import score as tscore
from pydca_tpu_torch import stats as tstats
from pydca_tpu_torch.alphabets import PROTEIN, RNA
from pydca_tpu_torch.backmap import SequenceBackmapper
from pydca_tpu_torch.io.fasta import MSA
from pydca_tpu_torch.plm import PlmDCA, PlmDCAException
from pydca_tpu_torch.meanfield import MeanFieldDCAException
from pydca_tpu_torch.synthetic import (
    planted_family, reference_from_row, spearman, top_k_overlap,
)
from test_torch_meanfield import dense, engines

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def random_case(l, q, seed, dtype=np.float64, scale=0.5):
    """Random coupling blocks and a synthetic regularised fi (pseudocount 0.5)."""
    rng = np.random.default_rng(seed)
    p = l * (l - 1) // 2
    blocks = rng.normal(scale=scale, size=(p, q - 1, q - 1)).astype(dtype)
    fi = (0.5 / q + 0.5 * rng.dirichlet(np.full(q, 0.5), size=l)).astype(dtype)
    return blocks, fi


def golden_case(name, q, dtype=np.float64):
    """The committed fitted params' blocks, with a synthetic fi_reg."""
    params = np.load(os.path.join(GOLDENS, f"ref_plm_{name}_it100.npz"))["params"]
    l = next(l for l in range(2, 4000) if l * q + l * (l - 1) // 2 * q * q == params.size)
    p = l * (l - 1) // 2
    blocks = params[l * q :].reshape(p, q, q)[:, : q - 1, : q - 1].astype(dtype)
    _, fi = random_case(l, q, seed=l, dtype=dtype)
    return l, q, np.ascontiguousarray(blocks), fi


def both_fields(blocks, fi, l, q):
    hj_, hjj = jscore.two_site_model_fields(jnp.asarray(blocks), jnp.asarray(fi), l, q)
    hi, hj, st = tscore.two_site_model_fields(
        torch.tensor(blocks), torch.tensor(fi), l, q, return_iters=True
    )
    return (np.asarray(hj_), np.asarray(hjj)), (hi.numpy(), hj.numpy()), st


CASES = [("random", 12, 5, 0), ("random", 9, 21, 1), ("random", 40, 5, 2),
         ("rf00167", None, 5, None), ("pf02826", None, 21, None)]


def make_case(kind, l, q, seed, dtype=np.float64):
    if kind == "random":
        return (l, q) + random_case(l, q, seed, dtype)
    return golden_case(kind, q, dtype)


@pytest.mark.parametrize("kind,l,q,seed", CASES)
def test_two_site_fields_and_di_float64_match_jax(kind, l, q, seed):
    l, q, blocks, fi = make_case(kind, l, q, seed)
    (hi_j, hj_j), (hi_t, hj_t), st = both_fields(blocks, fi, l, q)
    np.testing.assert_allclose(hi_t, hi_j, rtol=1e-10, atol=0)
    np.testing.assert_allclose(hj_t, hj_j, rtol=1e-10, atol=0)
    dj = np.asarray(jscore.direct_information(jnp.asarray(blocks), jnp.asarray(fi), l, q))
    dt = tscore.direct_information(torch.tensor(blocks), torch.tensor(fi), l, q).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-10, atol=1e-15)
    assert st.iters.dtype == torch.int32 and int(st.iters.min()) >= 1
    assert st.live[-1][1] == 0


@pytest.mark.parametrize("name,q", [("rf00167", 5), ("pf02826", 21)])
def test_di_float32_matches_jax(name, q):
    l, q, blocks, fi = golden_case(name, q, np.float32)
    dj = np.asarray(jscore.direct_information(jnp.asarray(blocks), jnp.asarray(fi), l, q))
    dt = tscore.direct_information(torch.tensor(blocks), torch.tensor(fi), l, q).numpy()
    assert dt.dtype == np.float32
    # a float32 pair may stop one iteration apart (its last change is near
    # the 1e-4 tolerance), moving small DI values by up to ~1e-6 nats
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=2e-6)
    sj, st = jscore.sorted_scores(dj, l), tscore.sorted_scores(dt, l)
    assert spearman(st, sj, l) >= 0.98
    assert top_k_overlap(st, sj, 20) >= 0.9


def plain_masked_loop(blocks, fi_reg, l, q):
    """The fixed point as one full batch to the end: every pair in every
    iteration, a stopped pair masked out (no compaction)."""
    p = blocks.shape[0]
    w = torch.ones((p, q, q), dtype=blocks.dtype)
    w[:, : q - 1, : q - 1] = torch.exp(blocks)
    wt = w.transpose(1, 2).contiguous()
    iu, ju = np.triu_indices(l, k=1)
    fi, fj = fi_reg[iu], fi_reg[ju]
    hi = torch.full((p, q), 1.0 / q, dtype=blocks.dtype)
    hj = hi.clone()
    it = torch.zeros(p, dtype=torch.int32)
    live = torch.ones(p, dtype=torch.bool)
    while bool(live.any()):
        xi = (w * hj[:, None, :]).sum(dim=-1)
        xj = (wt * hi[:, None, :]).sum(dim=-1)
        a = fi / xi
        a = a / a.sum(dim=-1, keepdim=True)
        b = fj / xj
        b = b / b.sum(dim=-1, keepdim=True)
        delta = torch.maximum((a - hi).abs().amax(-1), (b - hj).abs().amax(-1))
        hi = torch.where(live[:, None], a, hi)
        hj = torch.where(live[:, None], b, hj)
        it = it + live.to(torch.int32)
        live = live & (delta > tscore._TWO_SITE_TOL) & (it < tscore._TWO_SITE_MAX_ITERS)
    return hi, hj, it


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_compaction_equals_plain_masked_loop_bit_for_bit(dtype):
    l, q, blocks, fi = golden_case("rf00167", 5, dtype)
    b, f = torch.tensor(blocks), torch.tensor(fi)
    hi, hj, st = tscore.two_site_model_fields(b, f, l, q, return_iters=True)
    working = [ws for _, _, ws in st.live]
    assert len(set(working)) >= 3 and working[-1] < working[0] // 10  # it compacted
    hi_p, hj_p, it_p = plain_masked_loop(b, f, l, q)
    assert torch.equal(hi, hi_p) and torch.equal(hj, hj_p)
    assert torch.equal(st.iters, it_p)
    # the live counts fall after the first compaction
    lives = [n for _, n, _ in st.live]
    assert lives == sorted(lives, reverse=True)


def test_pair_result_does_not_depend_on_its_batch():
    l, q, blocks, fi = make_case("random", 30, 21, 3)
    b, f = torch.tensor(blocks), torch.tensor(fi)
    hi, hj = tscore.two_site_model_fields(b, f, l, q)
    iu, ju = np.triu_indices(l, k=1)
    for k in (0, 17, 200, len(iu) - 1):
        pair_fi = f[[iu[k], ju[k]]]  # a one-pair problem: sites 0 and 1
        hi1, hj1 = tscore.two_site_model_fields(b[k : k + 1], pair_fi, 2, q)
        assert torch.equal(hi1[0], hi[k]) and torch.equal(hj1[0], hj[k])


def test_iteration_cap_matches_jax(monkeypatch):
    """The 10^4 cap, lowered to 3 on both sides: every pair stops at the
    cap or earlier, with the same fields as the JAX loop under the same cap."""
    monkeypatch.setattr(tscore, "_TWO_SITE_MAX_ITERS", 3)
    monkeypatch.setattr(jscore, "_TWO_SITE_MAX_ITERS", 3)
    l, q, blocks, fi = make_case("random", 12, 5, 4)
    hi, hj, st = tscore.two_site_model_fields(
        torch.tensor(blocks), torch.tensor(fi), l, q, return_iters=True
    )
    # the unjitted JAX function traces anew and reads the patched constant
    hi_j, hj_j = jscore.two_site_model_fields.__wrapped__(
        jnp.asarray(blocks), jnp.asarray(fi), l, q
    )
    assert int(st.iters.max()) == 3 and int(st.iters.min()) >= 1
    np.testing.assert_allclose(hi.numpy(), np.asarray(hi_j), rtol=1e-10, atol=0)
    np.testing.assert_allclose(hj.numpy(), np.asarray(hj_j), rtol=1e-10, atol=0)


def test_return_iters_is_off_by_default():
    l, q, blocks, fi = make_case("random", 8, 5, 5)
    out = tscore.two_site_model_fields(torch.tensor(blocks), torch.tensor(fi), l, q)
    assert len(out) == 2
    di = tscore.direct_information(torch.tensor(blocks), torch.tensor(fi), l, q)
    assert di.shape == (l * (l - 1) // 2,)


# --------------------------------------------------------- mean-field engine
MF_FAMILIES = ["q21_family", "small_msa"]


@pytest.mark.parametrize("which", MF_FAMILIES)
@pytest.mark.parametrize("name", ["compute_sorted_DI", "compute_sorted_DI_APC"])
def test_meanfield_float64_di_equals_jax(which, name):
    data, j, t = engines(which, torch.float64)
    l = data.shape[1]
    got, want = dense(getattr(t, name)(), l), dense(getattr(j, name)(), l)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)
    got = t.get_site_pair_di_score()
    want = j.get_site_pair_di_score()
    assert got.keys() == want.keys()
    np.testing.assert_allclose(list(got.values()), [want[k] for k in got], rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("which", MF_FAMILIES)
def test_meanfield_float64_fields_equal_jax(which):
    _, j, t = engines(which, torch.float64)
    got, want = t.compute_fields(), j.compute_fields()
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(
        np.stack([got[i] for i in sorted(got)]), np.stack([want[i] for i in sorted(want)]),
        rtol=1e-8, atol=1e-10,
    )
    # explicit couplings: the JAX engine's, as numpy
    jc = np.asarray(j.compute_couplings())
    got = t.compute_fields(couplings=jc)
    np.testing.assert_allclose(got[3], np.asarray(j.compute_fields(couplings=jc)[3]),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("which", MF_FAMILIES)
@pytest.mark.parametrize("explicit", [False, True], ids=["implicit", "explicit"])
def test_meanfield_float64_two_site_fields_equal_jax(which, explicit):
    _, j, t = engines(which, torch.float64)
    if explicit:
        jc = np.asarray(j.compute_couplings())
        fi = np.asarray(j.get_reg_single_site_freqs())
        got = t.compute_two_site_model_fields(couplings=jc, reg_fi=fi)
        want = j.compute_two_site_model_fields(couplings=jc, reg_fi=fi)
        rtol = 1e-10  # the same inputs on both sides
    else:
        got, want = t.compute_two_site_model_fields(), j.compute_two_site_model_fields()
        rtol = 1e-8
    assert got.shape == want.shape == (len(want), 2, t.num_site_states)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=1e-13)


PARAM_ARGS = [
    {},
    {"ranked_by": "di_apc", "linear_dist": 2, "num_site_pairs": 7},
    {"ranked_by": "FN", "linear_dist": 0, "num_site_pairs": 1000},
    {"ranked_by": "DI", "num_site_pairs": 0},
]


def assert_params_equal(got, want, rtol, atol):
    (fields_t, couplings_t), (fields_j, couplings_j) = got, want
    assert [i for i, _ in fields_t] == [i for i, _ in fields_j]
    np.testing.assert_allclose(np.stack([f for _, f in fields_t]),
                               np.stack([np.asarray(f) for _, f in fields_j]),
                               rtol=rtol, atol=atol)
    assert [p for p, _ in couplings_t] == [p for p, _ in couplings_j]
    if couplings_j:
        np.testing.assert_allclose(np.stack([c for _, c in couplings_t]),
                                   np.stack([np.asarray(c) for _, c in couplings_j]),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("which", MF_FAMILIES)
@pytest.mark.parametrize("kwargs", PARAM_ARGS, ids=["default", "di_apc", "fn_all", "none"])
def test_meanfield_float64_compute_params_equals_jax(which, kwargs):
    _, j, t = engines(which, torch.float64)
    assert_params_equal(t.compute_params(**kwargs), j.compute_params(**kwargs),
                        rtol=1e-8, atol=1e-10)


def test_meanfield_shift_couplings_equals_jax():
    _, j, t = engines("small_msa", torch.float64)
    block = np.random.default_rng(0).normal(size=16)
    np.testing.assert_allclose(t.shift_couplings(block), j.shift_couplings(block),
                               rtol=1e-12, atol=1e-15)


def test_meanfield_di_path_builds_one_gram(monkeypatch):
    """The pipeline keeps its (L, q) fi: DI and the fields launch no second
    Gram; compute_fij still builds (and keeps) one, as the JAX package does."""
    calls = []
    gram = tstats.weighted_gram

    def counting(*args):
        calls.append(1)
        return gram(*args)

    monkeypatch.setattr(tstats, "weighted_gram", counting)
    data, j, t = engines("q21_family", torch.float32)
    t.compute_sorted_DI_APC()
    t.compute_fields()
    t.compute_params(ranked_by="DI")
    assert len(calls) == 1
    assert t._MeanFieldDCA__gram is None
    np.testing.assert_array_equal(t.get_single_site_freqs().numpy(),
                                  torch.diagonal(gram(torch.tensor(data), t.get_sequences_weight(), 21))
                                  .reshape(-1, 21).numpy())
    t.get_reg_pair_site_freqs()
    assert len(calls) == 2 and t._MeanFieldDCA__gram is not None


@pytest.mark.parametrize("explicit_fi", [False, True])
def test_meanfield_freqs_before_the_pipeline_build_one_gram(monkeypatch, explicit_fi):
    """Called before any couplings, fi then fij (or C from one given
    frequency) share one cached Gram."""
    calls = []
    gram = tstats.weighted_gram

    def counting(*args):
        calls.append(1)
        return gram(*args)

    monkeypatch.setattr(tstats, "weighted_gram", counting)
    _, j, t = engines("small_msa", torch.float64)
    fi = t.get_reg_single_site_freqs()
    if explicit_fi:
        c = t.construct_corr_mat(reg_fi=fi)
        np.testing.assert_allclose(c.numpy(), np.asarray(j.construct_corr_mat()),
                                   rtol=1e-10, atol=1e-14)
    else:
        fij = t.get_reg_pair_site_freqs()
        np.testing.assert_allclose(fij.numpy(), np.asarray(j.get_reg_pair_site_freqs()),
                                   rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(fi.numpy(), np.asarray(j.get_reg_single_site_freqs()),
                               rtol=1e-10, atol=1e-14)
    assert len(calls) == 1


@pytest.mark.parametrize("which", MF_FAMILIES)
def test_meanfield_float32_di_rank_bar(which):
    data, j, t = engines(which, torch.float32)
    l = data.shape[1]
    got, want = t.compute_sorted_DI_APC(), j.compute_sorted_DI_APC()
    assert spearman(got, want, l) >= 0.98
    assert top_k_overlap(got, want, 20) >= 0.9
    stages = [s for s in ("blocks", "two_site", "di", "sort") if t.timers.elapsed(s) > 0]
    assert stages == ["blocks", "two_site", "di", "sort"]
    assert t.two_site_stats.iters.shape == (l * (l - 1) // 2,)


def test_meanfield_bad_ranking_raises():
    _, _, t = engines("small_msa", torch.float32)
    with pytest.raises(MeanFieldDCAException, match="invalid ranking criterion"):
        t.compute_params(ranked_by="MI")


# ----------------------------------------------------------------- plm engine
PLM_FAMILIES = {
    "rna": (200, 18, 5, JRNA, RNA),
    "protein": (150, 13, 21, JPROTEIN, PROTEIN),
}


def plm_engines(which):
    """Both plm engines on one alignment, scoring the same explicit params."""
    n, l, q, jalph, talph = PLM_FAMILIES[which]
    codes, _ = planted_family(n, l, q, seed=l, n_pairs=3, n_ancestors=10)
    d = l * q + l * (l - 1) // 2 * q * q
    params = np.random.default_rng(q).normal(scale=0.3, size=d).astype(np.float32)
    j = JPlmDCA(JMSA(data=codes, alphabet=jalph), which)
    j.get_fields_and_couplings_from_backend = lambda: params  # test-side patch
    t = PlmDCA(MSA(data=codes, alphabet=talph), which, device="cpu")
    t.set_fields_and_couplings(params)
    return l, q, params, j, t


@pytest.mark.parametrize("which", sorted(PLM_FAMILIES))
@pytest.mark.parametrize("name", ["compute_sorted_DI", "compute_sorted_DI_APC"])
def test_plm_di_matches_jax(which, name):
    l, q, _, j, t = plm_engines(which)
    got, want = getattr(t, name)(), getattr(j, name)()
    np.testing.assert_allclose(dense(got, l), dense(want, l), rtol=1e-4, atol=1e-6)
    assert spearman(got, want, l) >= 0.98
    assert top_k_overlap(got, want, 20) >= 0.9
    np.testing.assert_allclose(t.compute_direct_info_unsorted_DI(),
                               j.compute_direct_info_unsorted_DI(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("which", sorted(PLM_FAMILIES))
@pytest.mark.parametrize("kwargs", PARAM_ARGS[:2], ids=["default", "di_apc"])
def test_plm_compute_params_matches_jax(which, kwargs):
    _, _, _, j, t = plm_engines(which)
    assert_params_equal(t.compute_params(**kwargs), j.compute_params(**kwargs),
                        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("which", sorted(PLM_FAMILIES))
def test_plm_param_extraction_matches_jax(which):
    l, q, params, j, t = plm_engines(which)
    for got, want in zip(t.get_fields_and_couplings_no_gap_state(),
                         j.get_fields_and_couplings_no_gap_state()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t.get_fields_and_couplings_from_backend(), params)
    for i, jj, a, b in [(0, 1, 0, 0), (0, l - 1, q - 1, 2), (3, 7, 1, q - 1), (l - 2, l - 1, 2, 3)]:
        k = t.map_index_couplings(i, jj, a, b)
        assert k == j.map_index_couplings(i, jj, a, b)
        assert params[k] == params[l * q + int(tstats.pair_index(i, jj, l)) * q * q + a * q + b]
    block = params[:16]
    np.testing.assert_allclose(t.shift_couplings(block if q == 5 else params[:400]),
                               j.shift_couplings(block if q == 5 else params[:400]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.get_reg_single_site_freqs().numpy(),
                               np.asarray(j.get_reg_single_site_freqs()), rtol=1e-6)


@pytest.mark.parametrize("which", sorted(PLM_FAMILIES))
@pytest.mark.parametrize("explicit", [False, True], ids=["implicit", "explicit"])
def test_plm_two_site_fields_match_jax(which, explicit):
    l, q, params, j, t = plm_engines(which)
    if explicit:
        couplings = j.get_couplings_no_gap_state() * np.float32(0.5)
        got = t.compute_two_site_model_fields(couplings=couplings)
        want = j.compute_two_site_model_fields(couplings=couplings)
    else:
        got, want = t.compute_two_site_model_fields(), j.compute_two_site_model_fields()
    assert got.shape == want.shape == (l * (l - 1) // 2, 2, q)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_plm_wrong_param_count_raises():
    _, _, params, _, t = plm_engines("rna")
    with pytest.raises(PlmDCAException, match="parameters"):
        t.set_fields_and_couplings(params[:-1])
    with pytest.raises(PlmDCAException, match="invalid ranking criterion"):
        t.compute_params(ranked_by="MI")


@pytest.mark.parametrize("engine", ["plm", "meanfield"])
@pytest.mark.parametrize(
    "method", ["compute_sorted_FN", "compute_sorted_DI_APC", "compute_params"]
)
def test_seqbackmapper_matches_jax(engine, method):
    """Each engine method with a real backmapper (a reference made from row
    7 of the alignment, so the template search runs) against the JAX
    engine's: the same mapped pairs and sites of the reference, values at
    the bar of the unmapped comparisons above (plm float32, mean-field
    float64)."""
    if engine == "plm":
        l, q, _, j, t = plm_engines("rna")
        rtol, atol = (1e-4, 1e-6) if "DI" in method else (1e-5, 1e-6)
    else:
        _, j, t = engines("small_msa", torch.float64)
        rtol, atol = 1e-8, 1e-10
    data = t.msa.data
    ref = reference_from_row(data, 7, t.msa.alphabet, seed=1, ends=(2, 3))
    kw = dict(alignment_data=list(data), ref_seq=ref, biomolecule=t.biomolecule)
    got = getattr(t, method)(seqbackmapper=SequenceBackmapper(device="cpu", **kw))
    want = getattr(j, method)(seqbackmapper=JSequenceBackmapper(**kw))
    assert t.refseq_mapping == JSequenceBackmapper(**kw).map_to_reference_sequence()
    if method == "compute_params":
        assert_params_equal(got, want, rtol=rtol, atol=atol)
        assert [i for i, _ in got[0]] == sorted(t.refseq_mapping.values())
        return
    assert len(got) == len(want) == len(t.refseq_mapping) * (len(t.refseq_mapping) - 1) // 2
    assert [p for p, _ in got] == [p for p, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=rtol, atol=atol)
