"""Port's streamed plm fit and generic L-BFGS loop vs ``pydca_tpu``.

Inputs are made from a numpy seed and go through the JAX function and its
port, float32 on both sides (the JAX side on the CPU, as
``tests/test_plm.py:152-201`` runs it).  One evaluation, one direction and
one line search agree to float32 tolerance; five generic-loop steps from
one shared state agree state for state; 100-iteration fits at ranking
level (FN-APC Spearman >= 0.98, top-20 overlap >= 0.9).
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pydca_tpu import plm as jplm
from pydca_tpu import stats as jstats
from pydca_tpu.alphabets import PROTEIN as JPROTEIN
from pydca_tpu.cli import plmdca_main as jcli
from pydca_tpu.io.fasta import MSA as JMSA
from pydca_tpu.ops import lbfgs as jl
from pydca_tpu_torch import alphabets as talph
from pydca_tpu_torch import plm as tplm
from pydca_tpu_torch import score as tscore
from pydca_tpu_torch import stats as tstats
from pydca_tpu_torch.cli import plmdca_main as tcli
from pydca_tpu_torch.io.fasta import MSA as TMSA
from pydca_tpu_torch.ops import lbfgs as tl
from pydca_tpu_torch.synthetic import planted_family, spearman, top_k_overlap, write_family_fasta
from test_torch_cli import read_scores
from test_torch_cli_subcommands import assert_headers_equal, split_file


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def random_problem(n=37, l=9, q=5, seed=3):
    """The JAX package's streaming test problem (``tests/test_plm.py:162-169``)."""
    rng = np.random.default_rng(seed)
    msa = rng.integers(0, q, (n, l)).astype(np.int32)
    w = rng.random(n).astype(np.float32)
    d = l * q + l * (l - 1) // 2 * q * q
    theta = rng.normal(scale=0.1, size=d).astype(np.float32)
    return msa, w, theta, np.float32(1.3), l, q


def jax_chunked(msa, w, block, lam, l, q):
    """JAX's streamed objective on ``_pad_to_blocks``' blocks."""
    mb, wb = jplm._pad_to_blocks(msa, jnp.asarray(w), block)
    pidx = jnp.asarray(jstats.pair_index_matrix(l))
    lam = jnp.float32(lam)
    return lambda t: jplm.plm_loss_and_grad_chunked(t, mb, wb, pidx, lam, lam, l, q)


def port_chunked(msa, w, block, lam, l, q):
    return tplm._make_loss_fun(torch.tensor(msa), torch.tensor(w), float(lam),
                               float(lam), l, q, block)


@pytest.mark.parametrize("block", [8, 13, 64])
def test_chunked_loss_and_grad_match_jax_and_full(block):
    msa, w, theta, lam, l, q = random_problem()
    fj, gj = jax_chunked(msa, w, block, lam, l, q)(jnp.asarray(theta))
    ft, gt = port_chunked(msa, w, block, lam, l, q)(torch.tensor(theta))
    ff, gf = tplm.plm_loss_and_grad(torch.tensor(theta), torch.tensor(msa), torch.tensor(w),
                                    float(lam), float(lam), l, q)
    for f_want, g_want in ((float(fj), np.asarray(gj)), (float(ff), gf.numpy())):
        np.testing.assert_allclose(float(ft), f_want, rtol=1e-5)
        np.testing.assert_allclose(gt.numpy(), g_want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("block", [1, 7, 1000])
def test_blocked_single_site_freqs_match_jax(block):
    msa, w, _, _, l, q = random_problem(n=200, l=11, q=21, seed=5)
    want = np.asarray(jstats.single_site_freqs(jnp.asarray(msa), jnp.asarray(w), q))
    got = tstats.single_site_freqs(torch.tensor(msa), torch.tensor(w), q, block=block)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    whole = tstats.single_site_freqs(torch.tensor(msa), torch.tensor(w), q)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6, atol=1e-7)


def random_history(k, m=5, dsz=400, seed=0):
    """Circular history of ``min(k, m)`` pairs (empty slots are zero rows
    with rho = 0), as ``tests/test_plm.py:318-347`` builds it; float32."""
    rng = np.random.default_rng(seed + k)
    s_hist, y_hist, rho = np.zeros((m, dsz)), np.zeros((m, dsz)), np.zeros(m)
    for t in range(max(0, k - m), k):
        slot = t % m
        s = rng.normal(size=dsz)
        y = s * rng.uniform(0.5, 2.0) + 0.1 * rng.normal(size=dsz)
        if s @ y <= 0:
            y = s
        s_hist[slot], y_hist[slot], rho[slot] = s, y, 1.0 / (s @ y)
    g = rng.normal(size=dsz)
    return [a.astype(np.float32) for a in (g, s_hist, y_hist, rho)]


@pytest.mark.parametrize("k", [0, 1, 3, 5, 7, 23])
def test_two_loop_matches_jax(k):
    g, s_hist, y_hist, rho = random_history(k)
    args = (jnp.asarray(g), jnp.asarray(s_hist), jnp.asarray(y_hist), jnp.asarray(rho),
            jnp.asarray(k, jnp.int32), 5)
    want = np.asarray(jl._two_loop(*args))
    want_ref = np.asarray(jl._two_loop_reference(*args))
    z = torch.tensor(np.concatenate([s_hist, y_hist]))
    got = tl._two_loop(torch.tensor(g), z, torch.tensor(rho), k)
    got_ref = tl._two_loop_reference(torch.tensor(g), z[:5], z[5:], torch.tensor(rho), k)
    for a in (got.numpy(), got_ref.numpy()):
        for b in (want, want_ref):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())


def plm_problem(n=120, l=10, q=5, seed=2, block=32):
    codes, _ = planted_family(n, l, q, seed=seed, n_pairs=2, n_ancestors=8)
    msa = codes.astype(np.int32)
    w = np.asarray(jstats.sequence_weights(jnp.asarray(msa), 0.8, q), np.float32)
    return msa, w, np.float32(0.2 * (l - 1)), l, q, block


@pytest.mark.parametrize("scale", [1.0, 40.0, 1e-3], ids=["first_step", "overshoot", "expand"])
def test_wolfe_linesearch_matches_jax(scale):
    """Both searches along the steepest-descent direction from the init,
    with step0 = scale / ||d|| (the k = 0 rule at scale 1)."""
    msa, w, lam, l, q, block = plm_problem()
    jfun = jax_chunked(msa, w, block, lam, l, q)
    tfun = port_chunked(msa, w, block, lam, l, q)
    x0 = np.asarray(jplm.init_params(jnp.asarray(msa), jnp.asarray(w), l, q))
    f0, g0 = jfun(jnp.asarray(x0))
    d = -np.asarray(g0)
    dg0 = np.float32(np.dot(np.asarray(g0, np.float64), d))
    step0 = np.float32(scale / np.linalg.norm(d))
    want = jl._wolfe_linesearch(
        jfun, jnp.asarray(x0), f0, g0, jnp.asarray(d), jnp.float32(dg0), jnp.float32(step0),
        jnp.float32(1e-4), jnp.float32(0.9), 10,
    )
    got = tl._wolfe_linesearch(
        tfun, torch.tensor(x0), np.float32(f0), torch.tensor(np.asarray(g0)), torch.tensor(d),
        dg0, step0, 1e-4, 0.9, 10,
    )
    assert (bool(got[3]), bool(got[4]), int(got[5])) == (bool(want[3]), bool(want[4]), int(want[5]))
    assert bool(got[3])
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5)
    assert rel_l2(got[0].numpy(), want[0]) <= 1e-5
    assert rel_l2(got[2].numpy(), want[2]) <= 1e-4


M = 5


@pytest.fixture(scope="module")
def generic_trajectories():
    """States k = 0..5 of both generic loops from JAX's ``_plm_lbfgs_state0``
    (chunked), carried into the port by ``lbfgs_state_from_numpy``."""
    msa, w, lam, l, q, block = plm_problem(n=200, l=16, seed=1, block=64)
    mb, wb = jplm._pad_to_blocks(msa, jnp.asarray(w), block)
    pidx = jnp.asarray(jstats.pair_index_matrix(l))
    jlam = jnp.float32(lam)
    js = jplm._plm_lbfgs_state0(mb, wb, pidx, jlam, jlam, l, q, M, chunked=True)
    js0 = jax.device_get(js)
    tmsa, tw = torch.tensor(msa), torch.tensor(w)
    own0 = tplm._plm_lbfgs_state0(tmsa, tw, float(lam), float(lam), l, q, M, block)
    ts = tplm.lbfgs_state_from_numpy(js0._asdict(), "cpu")
    jax_states, port_states = [js0], [snapshot(ts)]
    for _ in range(5):
        js = jplm._plm_lbfgs_steps(js, mb, wb, pidx, jlam, jlam, l, q, 1, chunked=True)
        tplm._plm_lbfgs_steps(ts, tmsa, tw, float(lam), float(lam), l, q, 1, block)
        jax_states.append(jax.device_get(js))
        port_states.append(snapshot(ts))
    return jax_states, port_states, snapshot(own0)


def snapshot(st):
    return dict(x=st.x.clone().numpy(), f=float(st.f), g=st.g.clone().numpy(),
                s_hist=st.s_hist.clone().numpy(), y_hist=st.y_hist.clone().numpy(),
                rho=st.rho.clone().numpy(), k=st.k, done=st.done, converged=st.converged,
                ls_failed=st.ls_failed, n_evals=st.n_evals)


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4, 5])
def test_generic_state_matches_jax(generic_trajectories, k):
    jax_states, port_states, own0 = generic_trajectories
    js, ts = jax_states[k], port_states[k]
    for name in ("k", "done", "converged", "ls_failed", "n_evals"):
        assert ts[name] == getattr(js, name), name
    assert ts["k"] == k and not ts["done"]
    np.testing.assert_allclose(ts["f"], float(js.f), rtol=1e-5)
    # five float32 steps: only reassociated sums separate the two loops
    for name in ("x", "g", "s_hist", "y_hist"):
        assert rel_l2(ts[name], getattr(js, name)) <= 1e-4, name
    np.testing.assert_allclose(ts["rho"], np.asarray(js.rho), rtol=1e-4)
    if k == 0:  # the port's own state0 against JAX's
        np.testing.assert_allclose(own0["f"], float(js.f), rtol=1e-5)
        assert rel_l2(own0["x"], js.x) <= 1e-6 and rel_l2(own0["g"], js.g) <= 1e-5
        assert (own0["k"], own0["n_evals"], own0["done"]) == (0, 1, False)


def fn_apc_sorted(x, l, q):
    p = l * (l - 1) // 2
    blocks = torch.tensor(np.asarray(x, np.float32))[l * q :].reshape(p, q, q)
    return tscore.sorted_scores(tscore.apc(tscore.frobenius_norms(blocks[:, : q - 1, : q - 1]), l), l)


@pytest.fixture(scope="module")
def streamed_fits():
    n, l, q = 400, 30, 5
    codes, _ = planted_family(n, l, q, seed=7, n_pairs=8, n_ancestors=16)
    msa = codes.astype(np.int32)
    w = np.asarray(jstats.sequence_weights(jnp.asarray(msa), 0.8, q), np.float32)
    lam = np.float32(0.2 * (l - 1))
    rj = jplm.fit_plm(jnp.asarray(msa), jnp.asarray(w), jnp.float32(lam), jnp.float32(lam),
                      l, q, max_iterations=100, seq_block=16)
    tmsa, tw = torch.tensor(msa), torch.tensor(w)
    rt = tplm.fit_plm(tmsa, tw, float(lam), float(lam), l, q, max_iterations=100, seq_block=16)
    rf = tplm.fit_plm(tmsa, tw, float(lam), float(lam), l, q, max_iterations=100)
    return dict(jax=rj, stream=rt, fused=rf, l=l, q=q)


@pytest.mark.parametrize("other", ["jax", "fused"])
def test_streamed_fit_meets_rank_bar(streamed_fits, other):
    fits, l, q = streamed_fits, streamed_fits["l"], streamed_fits["q"]
    st = fn_apc_sorted(fits["stream"].x, l, q)
    so = fn_apc_sorted(fits[other].x, l, q)
    assert spearman(st, so, l) >= 0.98
    assert top_k_overlap(st, so, 20) >= 0.9
    rt, ro = fits["stream"], fits[other]
    if other == "fused":  # the JAX package's bar, tests/test_plm.py:197-201
        assert abs(rt.num_iters - ro.num_iters) <= 3
        np.testing.assert_allclose(rt.fx, ro.fx, rtol=1e-4)
    # the generic loop reads at least twice an iteration (direction, step)
    assert rt.host_syncs >= 2 * rt.num_iters


THRESHOLD_L = 100
THRESHOLD_N = (1 << 30) // (4 * THRESHOLD_L * 21)  # the deepest fused alignment


@pytest.mark.parametrize(
    "n,seq_block,want",
    [
        (THRESHOLD_N, None, None),
        (THRESHOLD_N + 1, None, max(1024, (1 << 30) // (4 * THRESHOLD_L * 21))),
        (300, 64, 64),
    ],
    ids=["below", "past", "explicit"],
)
def test_auto_switch_matches_jax(n, seq_block, want):
    """Both engines on the same zero MSA (no fit): the same route."""
    data = np.zeros((n, THRESHOLD_L), np.int8)
    tinst = tplm.PlmDCA(TMSA(data=data, alphabet=talph.PROTEIN), "protein", device="cpu",
                        seq_block=seq_block)
    jinst = jplm.PlmDCA(JMSA(data=data, alphabet=JPROTEIN), "protein", seq_block=seq_block)
    assert tinst.seq_block == jinst._PlmDCA__seq_block == want
    assert tplm.streaming_block(n, THRESHOLD_L, 21) == (None if n <= THRESHOLD_N else want)


def test_invalid_seq_block_raises():
    data = np.zeros((10, 6), np.int8)
    with pytest.raises(tplm.PlmDCAException, match="seq_block"):
        tplm.PlmDCA(TMSA(data=data, alphabet=talph.RNA), "rna", device="cpu", seq_block=0)


def run_both_streamed(tmp_path, argv):
    """``argv`` (subcommand and flags, ``--seq_block`` kept) through the JAX
    and the port's CLI on one seeded RNA family; the two output dirs."""
    codes, _ = planted_family(300, 30, 5, seed=30, n_pairs=6, n_ancestors=12)
    fa = str(tmp_path / "fam.fa")
    write_family_fasta(fa, codes, talph.RNA)
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    args = vars(jcli.build_parser().parse_args([argv[0], "rna", fa] + argv[1:]))
    for key in ("mesh", "num_threads", "precision", "checkpoint", "param_space", "output_dir"):
        args.pop(key, None)
    jcli.execute_from_command_line(output_dir=out_j, mesh=None, **args)
    inst = tcli.run_plm_dca([argv[0], "rna", fa, "--device", "cpu", "--output_dir", out_t]
                            + argv[1:])
    assert inst.seq_block == 16
    assert sorted(os.listdir(out_j)) == sorted(os.listdir(out_t))
    return out_j, out_t


@pytest.mark.parametrize("command", ["compute_fn", "compute_di"])
def test_cli_seq_block_matches_jax_cli(tmp_path, command):
    out_j, out_t = run_both_streamed(tmp_path, [command, "--apc", "--seq_block", "16"])
    (name,) = os.listdir(out_j)
    assert_headers_equal(split_file(os.path.join(out_t, name))[0],
                         split_file(os.path.join(out_j, name))[0])
    st = read_scores(os.path.join(out_t, name))[1]
    sj = read_scores(os.path.join(out_j, name))[1]
    assert len(st) == len(sj) == 30 * 29 // 2
    scores = [s for _, s in st]
    assert scores == sorted(scores, reverse=True) and np.isfinite(scores).all()
    assert spearman(st, sj, 30) >= 0.98
    assert top_k_overlap(st, sj, 20) >= 0.9


def test_cli_compute_params_seq_block(tmp_path):
    """The streamed fit under ``compute_params``: the same files, headers
    and field sites as the JAX CLI's (two fits: values are not compared)."""
    out_j, out_t = run_both_streamed(tmp_path, ["compute_params", "--seq_block", "16"])
    for name in os.listdir(out_j):
        ht, bt = split_file(os.path.join(out_t, name))
        hj, bj = split_file(os.path.join(out_j, name))
        assert_headers_equal(ht, hj)
        assert len(bt) == len(bj) == 30
        if name.startswith("fields_"):
            assert [r.split(",")[0] for r in bt] == [r.split(",")[0] for r in bj]


def quadratic(xp, dtype):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(20, 20))
    amat = (a @ a.T + 20 * np.eye(20)).astype(np.float32)
    b = rng.normal(size=20).astype(np.float32)
    am, bv = xp.asarray(amat), xp.asarray(b)

    def fun(x):
        g = am @ x - bv
        return 0.5 * (x @ (am @ x)) - bv @ x, g

    return fun, np.zeros(20, np.float32), np.linalg.solve(amat.astype(np.float64), b)


def rosenbrock(xp, dtype):
    def fun(x):
        val = (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2
        g = xp.stack([-2 * (1 - x[0]) - 400 * x[0] * (x[1] - x[0] ** 2),
                      200 * (x[1] - x[0] ** 2)])
        return val, g

    return fun, np.array([-1.2, 1.0], np.float32), np.array([1.0, 1.0])


@pytest.mark.parametrize("make", [quadratic, rosenbrock], ids=["quadratic", "rosenbrock"])
def test_lbfgs_minimize_matches_jax(make):
    jfun, x0, sol = make(jnp, jnp.float32)
    tfun, _, _ = make(torch, torch.float32)
    opts = dict(max_iterations=500, epsilon=1e-6, max_linesearch=30)
    rj = jl.lbfgs_minimize(jfun, jnp.asarray(x0), **opts)
    rt = tl.lbfgs_minimize(tfun, torch.tensor(x0), **opts)
    np.testing.assert_allclose(rt.x.numpy(), sol, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-3, atol=1e-3)
    assert rt.converged or rt.linesearch_failed
    assert rt.n_evals >= rt.num_iters + 1
