"""Port's family batches (``pydca_tpu_torch.family``, both
``compute_fn_batch`` CLIs) vs ``pydca_tpu``'s vmapped ones, on the CPU.

The batches are ``tests/test_family.py``'s (three small RNA families, and
six mixed sizes for the buckets), made from numpy seeds.  Weights equal
JAX's exactly; five iterations of the lock-step fits agree with JAX's
vmapped padded fit at float32 tolerance (relative L2 <= 1e-3 per family,
as the k = 0..5 states of ``tests/test_torch_plm.py``) with every pad
entry exactly 0, and each lane with its family's own sequential fit
(``_fit_one``: the same k and evaluations, relative L2 <= 1e-4);
30-iteration FN-APC meets the JAX package's own family bar (rtol 2e-2,
atol 2e-3, the same top pair; ``tests/test_family.py:57``) and the ranking
bar; mean-field scores agree at rtol 1e-3, atol 1e-5
(``tests/test_family.py:81``).  Through the CLIs, the files are byte for
byte the JAX CLIs' when both get the same scores; given the same
parameters, the FN sums of the two packages (summed in another order)
agree to rtol 1e-5, with an absolute floor of 1e-6 of the largest score.
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pydca_tpu.family as jfam
import pydca_tpu_torch.family as tfam
from pydca_tpu_torch.ops.lbfgs import LBFGSState
from pydca_tpu.alphabets import RNA as JRNA
from pydca_tpu.cli import mfdca_main as jmf
from pydca_tpu.cli import plmdca_main as jplm
from pydca_tpu.io.fasta import MSA as JMSA
from pydca_tpu_torch import alphabets as talph
from pydca_tpu_torch.cli import mfdca_main as tmf
from pydca_tpu_torch.cli import plmdca_main as tplm
from pydca_tpu_torch.io.fasta import MSA as TMSA
from pydca_tpu_torch.io.fasta import read_msa
from pydca_tpu_torch.synthetic import spearman, top_k_overlap, write_family_fasta
from test_torch_cli import read_scores


def toy_codes(n, l, seed):
    """``tests/test_family.py:21-27``'s family."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 5, size=(3, l))
    msa = base[rng.integers(0, 3, size=n)]
    mut = rng.random((n, l)) < 0.3
    return np.where(mut, rng.integers(0, 5, size=(n, l)), msa).astype(np.int8)


def mixed_codes():
    """``tests/test_family.py:98-111``'s six mixed sizes."""
    sizes = [(30, 8), (34, 9), (120, 24), (110, 20), (28, 22), (130, 7)]
    out = []
    for k, (n, l) in enumerate(sizes):
        r = np.random.default_rng(100 + k)
        base = r.integers(0, 5, (4, l))
        msa = base[r.integers(0, 4, n)]
        mut = r.random((n, l)) < 0.2
        out.append(np.where(mut, r.integers(0, 5, (n, l)), msa).astype(np.int8))
    return out


BATCHES = {
    "toy": [toy_codes(40, 8, 0), toy_codes(25, 11, 1), toy_codes(55, 6, 2)],
    "mixed": mixed_codes(),
}


def both(codes_list, pad_to=None):
    jb = jfam.FamilyBatch([JMSA(data=c, alphabet=JRNA) for c in codes_list], pad_to=pad_to)
    tb = tfam.FamilyBatch([TMSA(data=c, alphabet=talph.RNA) for c in codes_list], pad_to=pad_to)
    return jb, tb


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name,pad_to", [("toy", None), ("toy", (64, 16)), ("mixed", None)])
def test_batch_layout_equals_jax(name, pad_to):
    jb, tb = both(BATCHES[name], pad_to)
    for field in ("data", "seq_mask", "site_mask", "lengths", "nseqs"):
        a, b = getattr(tb, field), getattr(jb, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert (tb.nmax, tb.lmax, tb.q, tb.num_families) == (jb.nmax, jb.lmax, jb.q, jb.num_families)


@pytest.mark.parametrize("name", ["toy", "mixed"])
@pytest.mark.parametrize("seqid", [0.8, 0.5, 1.0])
def test_family_weights_equal_jax(name, seqid):
    """Exactly equal, pad rows 0; at seqid = 1.0 no row passes and every
    weight is 1 / max(0, 1) = 1."""
    jb, tb = both(BATCHES[name])
    want = np.asarray(jfam.family_sequence_weights(jb, seqid))
    got = tfam.family_sequence_weights(tb, seqid, device="cpu")
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert np.array_equal(got.numpy(), want)
    if seqid == 1.0:
        assert np.array_equal(got.numpy(), tb.seq_mask.astype(np.float32))


@pytest.fixture(scope="module")
def fits5():
    jb, tb = both(BATCHES["toy"])
    jt, js = jfam.family_plm_fit(jb, max_iterations=5)
    tt, ts = tfam.family_plm_fit(tb, max_iterations=5, device="cpu")
    return jb, tb, np.asarray(jt), js, tt.numpy(), ts


@pytest.mark.parametrize("f", [0, 1, 2])
def test_family_plm_fit_matches_jax(fits5, f):
    jb, tb, jt, js, tt, ts = fits5
    assert tt.shape == jt.shape
    assert ts[f].k == int(js.k[f]) == 5
    assert ts[f].n_evals == int(js.n_evals[f])
    assert rel_l2(tt[f], jt[f]) <= 1e-3
    np.testing.assert_allclose(float(ts[f].f), float(js.f[f]), rtol=1e-4)


@pytest.mark.parametrize("f", [0, 1, 2])
def test_family_pad_entries_are_zero(fits5, f):
    """Fields of pad sites and couplings of every pair that touches one."""
    tb, tt = fits5[1], fits5[4]
    lmax, q, l_f = tb.lmax, tb.q, int(tb.lengths[f])
    h = tt[f, : lmax * q].reshape(lmax, q)
    assert np.all(h[l_f:] == 0.0)
    iu, ju = np.triu_indices(lmax, k=1)
    j = tt[f, lmax * q :].reshape(-1, q, q)
    assert np.all(j[ju >= l_f] == 0.0)
    assert np.any(j[ju < l_f] != 0.0)


@pytest.fixture(scope="module")
def scores30():
    jb, tb = both(BATCHES["toy"])
    jt, _ = jfam.family_plm_fit(jb, max_iterations=30)
    tt, _ = tfam.family_plm_fit(tb, max_iterations=30, device="cpu")
    return (jfam.family_plm_scores(jb, jt, apc=True), tfam.family_plm_scores(tb, tt, apc=True),
            [int(x) for x in tb.lengths])


@pytest.mark.parametrize("f", [0, 1, 2])
def test_family_fn_apc_meets_jax_bars(scores30, f):
    sj, st, lengths = scores30
    l_f = lengths[f]
    dj, dt = dict(sj[f]), dict(st[f])
    assert set(dj) == set(dt)
    keys = sorted(dj)
    np.testing.assert_allclose([dt[k] for k in keys], [dj[k] for k in keys],
                               rtol=2e-2, atol=2e-3)
    assert st[f][0][0] == sj[f][0][0]
    assert spearman(st[f], sj[f], l_f) >= 0.98
    k = min(20, l_f * (l_f - 1) // 2)
    assert top_k_overlap(st[f], sj[f], k) >= 0.9


@pytest.mark.parametrize("name", ["toy", "mixed"])
def test_family_meanfield_scores_match_jax(name):
    jb, tb = both(BATCHES[name])
    sj = jfam.family_meanfield_scores(jb, pseudocount=0.5, apc=True)
    st = tfam.family_meanfield_scores(tb, pseudocount=0.5, apc=True, device="cpu")
    for a, b in zip(st, sj):
        da, db = dict(a), dict(b)
        assert set(da) == set(db)
        keys = sorted(db)
        np.testing.assert_allclose([da[k] for k in keys], [db[k] for k in keys],
                                   rtol=1e-3, atol=1e-5)


def test_family_mf_couplings_are_jax_real_block():
    """JAX's padded inverse is block-diagonal: its real block is the
    port's unpadded inverse (float32, rtol 1e-4)."""
    jb, tb = both(BATCHES["toy"])
    w = jfam.family_sequence_weights(jb, 0.8)
    want = np.asarray(jfam._family_mf_couplings(
        jnp.asarray(jb.data), w, jnp.asarray(jb.site_mask, jnp.float32), jnp.float32(0.5),
        jb.lmax, jb.q))
    tw = tfam.family_sequence_weights(tb, 0.8, device="cpu")
    qm1 = tb.q - 1
    for f in range(tb.num_families):
        n, l = int(tb.nseqs[f]), int(tb.lengths[f])
        got = tfam._family_mf_couplings(tfam._family_codes(tb, f, "cpu"), tw[f, :n], 0.5, l,
                                        tb.q).numpy()
        real = want[f, : l * qm1, : l * qm1]
        np.testing.assert_allclose(got, real, rtol=1e-4, atol=1e-5 * np.abs(real).max())
        # the pad block is the identity's negative, the cross blocks zero
        assert np.all(want[f, : l * qm1, l * qm1 :] == 0.0)


@pytest.mark.parametrize("kwargs", [{}, {"min_n": 16, "min_l": 4}, {"min_n": 256, "min_l": 64}])
def test_bucket_families_and_flop_stats_equal_jax(kwargs):
    codes = BATCHES["mixed"]
    jm = [JMSA(data=c, alphabet=JRNA) for c in codes]
    tm = [TMSA(data=c, alphabet=talph.RNA) for c in codes]
    groups = tfam.bucket_families(tm, **kwargs)
    assert groups == jfam.bucket_families(jm, **kwargs)
    assert tfam.padded_flop_stats(tm, groups) == jfam.padded_flop_stats(jm, groups)
    assert tfam.padded_flop_stats(tm) == jfam.padded_flop_stats(jm)


def test_bucketed_fit_matches_jax():
    codes = BATCHES["mixed"]
    jm = [JMSA(data=c, alphabet=JRNA) for c in codes]
    tm = [TMSA(data=c, alphabet=talph.RNA) for c in codes]
    seen = []
    sj, dj = jfam.family_plm_fit_bucketed(jm, max_iterations=8, min_n=16, min_l=4)
    st, dt = tfam.family_plm_fit_bucketed(tm, max_iterations=8, min_n=16, min_l=4,
                                          device="cpu",
                                          progress_fn=lambda i, s, b: seen.append((i, s.k, b)))
    assert dt == dj and dt["num_buckets"] >= 2
    assert sorted(i for i, _, _ in seen) == list(range(len(codes)))
    assert all(k == 8 for _, k, _ in seen)
    # one lock-step batch a bucket, each at its own maxima
    groups = tfam.bucket_families(tm, min_n=16, min_l=4)
    runs = {id(b): b for _, _, b in seen}
    assert len(runs) == len(groups)
    assert sorted((b.lanes, b.shape) for b in runs.values()) == sorted(
        (len(ix), (max(codes[i].shape[0] for i in ix), max(codes[i].shape[1] for i in ix)))
        for ix in groups.values())
    for a, b in zip(st, sj):
        da, db = dict(a), dict(b)
        assert set(da) == set(db)
        keys = sorted(db)
        np.testing.assert_allclose([da[k] for k in keys], [db[k] for k in keys],
                                   rtol=2e-2, atol=2e-3)


def test_padding_does_not_change_the_port_fit():
    """The lock-step fit pads to the batch's own maxima: ``pad_to`` changes
    only where the parameters are placed, not one bit of them."""
    codes = BATCHES["toy"]
    tight = tfam.FamilyBatch([TMSA(data=c, alphabet=talph.RNA) for c in codes])
    padded = tfam.FamilyBatch([TMSA(data=c, alphabet=talph.RNA) for c in codes], pad_to=(64, 16))
    t1, _ = tfam.family_plm_fit(tight, max_iterations=6, device="cpu")
    t2, _ = tfam.family_plm_fit(padded, max_iterations=6, device="cpu")
    for a, b in zip(tfam.family_plm_scores(tight, t1), tfam.family_plm_scores(padded, t2)):
        assert a == b


@pytest.mark.parametrize("name", ["toy", "mixed"])
def test_bucketed_scores_equal_the_padded_fit(name):
    """The batch route fits each bucket in lock-step and scores each family
    from its own parameters; ``family_plm_fit`` of each bucket's families
    gives the same scores from its padded parameters, bit for bit, and
    they stay on the host."""
    codes = BATCHES[name]
    msas = [TMSA(data=c, alphabet=talph.RNA) for c in codes]
    direct, _ = tfam.family_plm_fit_bucketed(msas, max_iterations=6, device="cpu")
    groups = tfam.bucket_families(msas)
    assert len(groups) == (1 if name == "toy" else 4)
    for idxs in groups.values():
        tb = tfam.FamilyBatch([msas[i] for i in idxs])
        tt, states = tfam.family_plm_fit(tb, max_iterations=6, device="cpu")
        assert tt.device.type == "cpu" and all(st.x.device.type == "cpu" for st in states)
        assert [direct[i] for i in idxs] == tfam.family_plm_scores(tb, tt)


@pytest.mark.parametrize("name", ["toy", "mixed"])
def test_lockstep_lanes_equal_fit_one(name):
    """Each lane of one lock-step batch against its family's own sequential
    fit at its own shape (``_fit_one``), five iterations: the same
    iterations and evaluations, parameters at relative L2 <= 1e-4 (the
    lane's products run at the batch's padded shape, summed in another
    order)."""
    tb = tfam.FamilyBatch([TMSA(data=c, alphabet=talph.RNA) for c in BATCHES[name]])
    runs = []
    _, states = tfam.family_plm_fit(tb, max_iterations=5, device="cpu",
                                    progress_fn=lambda f, st, b: runs.append(b))
    assert len({id(b) for b in runs}) == 1 and runs[0].lanes == tb.num_families
    assert runs[0].shape == (int(tb.nseqs.max()), int(tb.lengths.max()))
    w = tfam.family_sequence_weights(tb, 0.8, device="cpu")
    seq_syncs = 0
    for f, st in enumerate(states):
        n, l = int(tb.nseqs[f]), int(tb.lengths[f])
        lam = np.float32(0.2 * (l - 1))
        one = tfam._fit_one(tfam._family_codes(tb, f, "cpu"), w[f, :n], lam, lam, l, tb.q,
                            max_iterations=5)
        assert (st.k, st.n_evals, st.done, st.converged) == (
            one.k, one.n_evals, one.done, one.converged)
        assert st.x.shape == one.x.shape and rel_l2(st.x, one.x) <= 1e-4
        seq_syncs += one.host_syncs
    # one read a round serves every lane
    assert runs[0].host_syncs == states[0].host_syncs < seq_syncs
    assert runs[0].lane_iterations == sum(st.k for st in states)


def test_lockstep_budget_splits_a_batch(monkeypatch):
    """A byte budget below the whole batch's lanes splits it into
    consecutive lock-step sub-batches, each within the budget; the scores
    equal the unsplit batch's (relative L2 <= 1e-5 a family: the
    sub-batches pad to their own maxima)."""
    tb = tfam.FamilyBatch([TMSA(data=c, alphabet=talph.RNA) for c in BATCHES["mixed"]])
    whole, _ = tfam.family_plm_fit(tb, max_iterations=5, device="cpu")
    budget = 2 * tfam.lockstep_lane_bytes(tb.nmax, tb.lmax, tb.q)
    monkeypatch.setattr(tfam, "LOCKSTEP_MAX_BYTES", budget)
    runs = []
    split, _ = tfam.family_plm_fit(tb, max_iterations=5, device="cpu",
                                   progress_fn=lambda f, st, b: runs.append((f, b)))
    batches = list({id(b): b for _, b in runs}.values())
    assert len(batches) >= 3
    assert [f for f, _ in runs] == list(range(tb.num_families))
    for b in batches:
        assert b.lanes == 1 or b.lanes * tfam.lockstep_lane_bytes(*b.shape, tb.q) <= budget
    for a, b in zip(tfam.family_plm_scores(tb, split), tfam.family_plm_scores(tb, whole)):
        assert [k for k, _ in sorted(a)] == [k for k, _ in sorted(b)]
        assert rel_l2([v for _, v in sorted(a)], [v for _, v in sorted(b)]) <= 1e-5


def write_batch(tmp_path, codes_list):
    files = []
    for k, c in enumerate(codes_list):
        path = str(tmp_path / f"fam{k}.fa")
        write_family_fasta(path, c, talph.RNA)
        files.append(path)
    return files


def read_bytes(directory):
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory))}


@pytest.fixture(scope="module")
def family_thetas():
    """Each toy family's own parameters (a JAX fit at its own shape)."""
    codes = BATCHES["toy"]
    out = []
    for c in codes:
        jb = jfam.FamilyBatch([JMSA(data=c, alphabet=JRNA)])
        out.append(np.asarray(jfam.family_plm_fit(jb, max_iterations=10)[0])[0])
    return out


def pad_theta(theta, l, lmax, q):
    out = np.zeros(lmax * q + lmax * (lmax - 1) // 2 * q * q, np.float32)
    out[: l * q] = theta[: l * q]
    sel = jfam._family_pair_select(l, lmax)
    out[lmax * q :].reshape(-1, q * q)[sel] = theta[l * q :].reshape(-1, q * q)
    return out


def patch_plm_fits(monkeypatch, thetas, codes_list):
    """Both packages' fits return the given per-family parameters (the
    families' lengths differ: the length names the family)."""
    by_len = {c.shape[1]: t for c, t in zip(codes_list, thetas)}

    def jax_fit(batch, **kwargs):
        rows = [pad_theta(by_len[m.seqs_len], m.seqs_len, batch.lmax, batch.q)
                for m in batch.msas]
        return jnp.asarray(np.stack(rows)), None

    def port_fit(codes, weights, lambda_h, lambda_j, q, **kwargs):
        states = []
        for c in codes:
            x = torch.tensor(by_len[c.shape[1]])
            states.append(LBFGSState(x=x, f=np.float32(0.0), g=torch.zeros_like(x),
                                     z=torch.zeros((10, x.numel())), rho=torch.zeros(5), k=0,
                                     done=True, converged=True, ls_failed=False, n_evals=1))
        shape = (max(c.shape[0] for c in codes), max(c.shape[1] for c in codes))
        return states, tfam.LockstepBatch(len(codes), shape, 0.0, 1, 0)

    monkeypatch.setattr(jfam, "family_plm_fit", jax_fit)
    monkeypatch.setattr(tfam, "_fit_lockstep", port_fit)


def run_plm_batch(tmp_path, files, flags):
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jplm.run_plm_dca(["compute_fn_batch", "rna"] + files + ["--output_dir", out_j] + flags)
    run = tplm.run_plm_dca(["compute_fn_batch", "rna"] + files
                           + ["--output_dir", out_t, "--device", "cpu"] + flags)
    return out_j, out_t, run


@pytest.mark.parametrize("flags", [["--apc"], [], ["--apc", "--no_bucket"]])
def test_plm_batch_cli_same_parameters(tmp_path, monkeypatch, family_thetas, flags):
    """Both CLIs score the same parameters: the same files and headers,
    byte for byte, and scores to rtol 1e-5."""
    codes = BATCHES["toy"]
    patch_plm_fits(monkeypatch, family_thetas, codes)
    files = write_batch(tmp_path, codes)
    out_j, out_t, run = run_plm_batch(tmp_path, files, flags)
    assert sorted(os.listdir(out_j)) == sorted(os.listdir(out_t)) == sorted(
        os.path.basename(p) for p in run.paths)
    for name in os.listdir(out_j):
        hj, sj = read_scores(os.path.join(out_j, name))
        ht, st = read_scores(os.path.join(out_t, name))
        assert ht == hj and "#      Computed in a family batch of 3 MSAs\n" in ht
        dj, dt = dict(sj), dict(st)
        assert set(dj) == set(dt)
        keys = sorted(dj)
        want = np.array([dj[k] for k in keys])
        # APC values cross zero: the floor is a few float32 ulps of the largest
        np.testing.assert_allclose([dt[k] for k in keys], want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
        assert st[0][0] == sj[0][0]


def test_plm_batch_cli_same_scores_byte_identical(tmp_path, monkeypatch):
    codes = BATCHES["toy"]
    files = write_batch(tmp_path, codes)
    tb = tfam.FamilyBatch([TMSA(data=c, alphabet=talph.RNA) for c in codes])
    tt, states = tfam.family_plm_fit(tb, max_iterations=5, device="cpu")
    scores = tfam.family_plm_scores(tb, tt)
    stats_d = dict(tfam.padded_flop_stats(tb.msas), num_buckets=2)

    def port_batch(msas, progress_fn, **kwargs):
        run = tfam.LockstepBatch(len(states), (tb.nmax, tb.lmax), 1.0, 1, 5 * len(states))
        for f, st in enumerate(states):
            progress_fn(f, st, run)
        return scores, stats_d

    monkeypatch.setattr(jfam, "family_plm_fit_bucketed", lambda msas, **kw: (scores, stats_d))
    monkeypatch.setattr(tplm, "family_plm_fit_bucketed", port_batch)
    out_j, out_t, _ = run_plm_batch(tmp_path, files, ["--apc"])
    assert read_bytes(out_t) == read_bytes(out_j)


def run_mf_batch(tmp_path, files, flags):
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jmf.run_meanfield_dca(["compute_fn_batch", "rna"] + files + ["--output_dir", out_j] + flags)
    run = tmf.run_meanfield_dca(["compute_fn_batch", "rna"] + files
                                + ["--output_dir", out_t, "--device", "cpu"] + flags)
    return out_j, out_t, run


def test_mf_batch_cli_same_scores_byte_identical(tmp_path, monkeypatch):
    codes = BATCHES["toy"]
    files = write_batch(tmp_path, codes)
    tb = tfam.FamilyBatch([TMSA(data=c, alphabet=talph.RNA) for c in codes])
    scores = tfam.family_meanfield_scores(tb, device="cpu")
    monkeypatch.setattr(jfam, "family_meanfield_scores", lambda batch, **kw: scores)
    monkeypatch.setattr(tmf, "family_meanfield_scores", lambda batch, **kw: scores)
    out_j, out_t, run = run_mf_batch(tmp_path, files, ["--apc"])
    assert read_bytes(out_t) == read_bytes(out_j)
    assert run.fits == [] and len(run.paths) == 3


@pytest.mark.parametrize("flags", [["--apc"], ["--seqid", "0.7", "--pseudocount", "0.3"]])
def test_mf_batch_cli_matches_jax(tmp_path, flags):
    codes = BATCHES["mixed"]
    files = write_batch(tmp_path, codes)
    out_j, out_t, _ = run_mf_batch(tmp_path, files, flags)
    assert sorted(os.listdir(out_j)) == sorted(os.listdir(out_t))
    for name in os.listdir(out_j):
        hj, sj = read_scores(os.path.join(out_j, name))
        ht, st = read_scores(os.path.join(out_t, name))
        assert ht == hj
        dj, dt = dict(sj), dict(st)
        keys = sorted(dj)
        np.testing.assert_allclose([dt[k] for k in keys], [dj[k] for k in keys],
                                   rtol=1e-3, atol=1e-5)


def test_plm_batch_cli_fits_match_jax(tmp_path):
    """Unpatched fits through both CLIs (30 iterations): the JAX package's
    family bar and the ranking bar on every family."""
    codes = BATCHES["toy"]
    files = write_batch(tmp_path, codes)
    out_j, out_t, run = run_plm_batch(tmp_path, files, ["--apc", "--max_iterations", "30"])
    assert len(run.fits) == 3
    assert all(0 < f.num_iters <= 30 and f.n_evals > f.num_iters
               and run.batches[f.batch].seconds > 0 for f in run.fits)
    for c, name in zip(codes, sorted(os.listdir(out_j))):
        l = c.shape[1]
        hj, sj = read_scores(os.path.join(out_j, name))
        ht, st = read_scores(os.path.join(out_t, name))
        assert ht == hj
        dj, dt = dict(sj), dict(st)
        keys = sorted(dj)
        np.testing.assert_allclose([dt[k] for k in keys], [dj[k] for k in keys],
                                   rtol=2e-2, atol=2e-3)
        assert spearman(st, sj, l) >= 0.98
        assert top_k_overlap(st, sj, min(20, l * (l - 1) // 2)) >= 0.9


def test_plm_batch_cli_no_bucket_changes_nothing(tmp_path, caplog):
    """``--no_bucket`` changes the batching, not the result: one lock-step
    batch at the batch maxima instead of one a bucket, as the log says; the
    same files and headers, the scores at the JAX package's family bar
    (rtol 2e-2, atol 2e-3) with the same top pair (the products run at
    other padded shapes, summed in another order)."""
    codes = BATCHES["mixed"]
    files = write_batch(tmp_path, codes)
    outs, runs = [], []
    for flags in ([], ["--no_bucket"]):
        outs.append(str(tmp_path / f"out{len(outs)}"))
        caplog.clear()
        with caplog.at_level("INFO", logger="pydca_tpu_torch.cli.plmdca_main"):
            runs.append(tplm.run_plm_dca(["compute_fn_batch", "rna"] + files + [
                "--apc", "--max_iterations", "4", "--device", "cpu", "--output_dir", outs[-1]]
                + flags))
        if flags:
            assert "6 families in one block (--no_bucket), 1 lock-step batches" in caplog.text
        else:
            assert "6 families in 4 buckets, 4 lock-step batches" in caplog.text
    assert [len(r.batches) for r in runs] == [4, 1]
    read = [read_msa(f, "rna") for f in files]
    assert runs[1].batches[0].shape == (max(m.num_seqs for m in read), 24)
    assert runs[1].batches[0].lanes == 6
    assert sorted(os.listdir(outs[0])) == sorted(os.listdir(outs[1]))
    for name in os.listdir(outs[0]):
        h0, s0 = read_scores(os.path.join(outs[0], name))
        h1, s1 = read_scores(os.path.join(outs[1], name))
        assert h1 == h0
        d0, d1 = dict(s0), dict(s1)
        keys = sorted(d0)
        np.testing.assert_allclose([d1[k] for k in keys], [d0[k] for k in keys],
                                   rtol=2e-2, atol=2e-3)
        assert s1[0][0] == s0[0][0]


@pytest.mark.parametrize("name,iters", [("toy", 30), ("mixed", 8)])
def test_plm_batch_cli_no_bucket_fits_match_jax(tmp_path, name, iters):
    """Unpatched ``--no_bucket`` fits through both CLIs (one padded block
    in each): the JAX package's family bar and the same top pair on every
    family, at the iterations of the bucketed CLI test (toy) and of
    ``test_bucketed_fit_matches_jax`` (mixed)."""
    codes = BATCHES[name]
    files = write_batch(tmp_path, codes)
    out_j, out_t, run = run_plm_batch(tmp_path, files, [
        "--apc", "--no_bucket", "--max_iterations", str(iters)])
    assert len(run.batches) == 1 and run.batches[0].lanes == len(codes)
    assert all(f.batch == 0 and 0 < f.num_iters <= iters for f in run.fits)
    for name_ in os.listdir(out_j):
        hj, sj = read_scores(os.path.join(out_j, name_))
        ht, st = read_scores(os.path.join(out_t, name_))
        assert ht == hj
        dj, dt = dict(sj), dict(st)
        keys = sorted(dj)
        np.testing.assert_allclose([dt[k] for k in keys], [dj[k] for k in keys],
                                   rtol=2e-2, atol=2e-3)
        assert st[0][0] == sj[0][0]


@pytest.mark.parametrize("cli,folder", [("plmdca", "PLMDCA_batch_output"),
                                        ("mfdca", "MFDCA_batch_output")])
def test_batch_cli_default_output_dir(tmp_path, monkeypatch, cli, folder):
    files = write_batch(tmp_path, BATCHES["toy"][:2])
    monkeypatch.chdir(tmp_path)
    argv = ["compute_fn_batch", "rna"] + files + ["--device", "cpu"]
    if cli == "plmdca":
        run = tplm.run_plm_dca(argv + ["--max_iterations", "3"])
    else:
        run = tmf.run_meanfield_dca(argv)
    assert sorted(os.listdir(tmp_path / folder)) == [
        f"{'PLMDCA' if cli == 'plmdca' else 'MFDCA'}_raw_fn_scores_fam{k}.txt" for k in (0, 1)]
    assert [os.path.dirname(p) for p in run.paths] == [folder, folder]


def test_rna_sweep_is_the_jax_bench_sweep(monkeypatch):
    """``synthetic.rna_family_sweep`` draws the JAX package's benchmark
    families (``bench.py:468-491``) bit for bit: the bench is stopped at
    its first use of the families."""
    import bench
    from pydca_tpu_torch.synthetic import rna_family_sweep

    seen = []

    class Drawn(Exception):
        pass

    def capture(msas, pad_to=None):
        seen.extend(m.data for m in msas)
        raise Drawn

    monkeypatch.setattr(jfam, "FamilyBatch", capture)
    with pytest.raises(Drawn):
        bench.bench_family()
    ours = rna_family_sweep()
    assert len(seen) == len(ours) == 32
    assert all(np.array_equal(a, b) for a, b in zip(seen, ours))
