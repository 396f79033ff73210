"""Port's plm objective and fused L-BFGS loop vs ``pydca_tpu.plm``.

Same numpy-seeded inputs on both sides, float32 throughout.  Short runs
are compared state for state; the 100-iteration fit at ranking level
(carried logits are never re-synced against theta and sums run in another
order, so long trajectories drift apart at float32 rounding).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import __graft_entry__
from pydca_tpu import plm as jplm
from pydca_tpu import score as jscore
from pydca_tpu import stats as jstats
from pydca_tpu_torch import plm as tplm
from pydca_tpu_torch import score as tscore
from pydca_tpu_torch import stats as tstats
from pydca_tpu_torch.synthetic import planted_family, spearman, top_k_overlap


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def q21_problem():
    n, l, q = 120, 12, 21
    msa = __graft_entry__._tiny_problem(n=n, l=l, q=q, seed=3)
    d = l * q + l * (l - 1) // 2 * q * q
    theta = np.random.default_rng(2).normal(scale=0.05, size=d).astype(np.float32)
    w = np.random.default_rng(4).random(n).astype(np.float32)
    return msa, theta, w, np.float32(0.2 * (l - 1)), l, q


def entry_problem():
    _, (theta, msa, w, _, lam, _) = __graft_entry__.entry()
    return (np.asarray(msa), np.asarray(theta), np.asarray(w), np.float32(lam),
            32, 5)


@pytest.mark.parametrize("make", [entry_problem, q21_problem], ids=["entry_q5", "q21"])
def test_loss_and_grad_match_jax(make):
    msa, theta, w, lam, l, q = make()
    fj, gj = jplm.plm_loss_and_grad(
        jnp.asarray(theta), jnp.asarray(msa), jnp.asarray(w),
        jnp.asarray(jstats.pair_index_matrix(l)), jnp.float32(lam),
        jnp.float32(lam), l, q,
    )
    ft, gt = tplm.plm_loss_and_grad(
        torch.tensor(theta), torch.tensor(msa), torch.tensor(w),
        float(lam), float(lam), l, q,
    )
    # float32 sums over N*L terms in another order
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-5)
    assert rel_l2(gt.numpy(), gj) <= 1e-5


def test_expand_and_pullback_are_adjoint_and_match_jax():
    l, q = 7, 5
    rng = np.random.default_rng(0)
    jf = rng.normal(size=l * (l - 1) // 2 * q * q).astype(np.float32)
    w_port = tplm._expand_w4(torch.tensor(jf), l, q)
    w_jax = np.asarray(jplm._expand_w4(jnp.asarray(jf), l, q)).reshape(l * q, q * l)
    np.testing.assert_array_equal(w_port.numpy(), w_jax)  # pure data movement
    cot = rng.normal(size=(l * q, q * l)).astype(np.float32)
    back = tplm._w4_cot_to_compact(torch.tensor(cot), l, q)
    back_jax = np.asarray(jplm._w4_cot_to_compact(jnp.asarray(cot), l, q))
    np.testing.assert_allclose(back.numpy(), back_jax, rtol=1e-6)
    # <E(j), G> == <j, E^T(G)>, in float64 to isolate the index maps
    jf64, cot64 = torch.tensor(jf).double(), torch.tensor(cot).double()
    lhs = float((tplm._expand_w4(jf64, l, q) * cot64).sum())
    rhs = float((jf64 * tplm._w4_cot_to_compact(cot64, l, q)).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-9)


N, L, Q, M = 200, 24, 5, 5


@pytest.fixture(scope="module")
def trajectories():
    """States k = 0..5 of both packages from the same inputs."""
    codes, _ = planted_family(N, L, Q, seed=1, n_pairs=4, n_ancestors=8)
    msa = codes.astype(np.int32)
    w = np.asarray(jstats.sequence_weights(jnp.asarray(msa), 0.8, Q), np.float32)
    lam = np.float32(0.2 * (L - 1))
    jmsa, jw, jlam = jnp.asarray(msa), jnp.asarray(w), jnp.float32(lam)
    x1h, maskq = jplm._prep_msa_jit(jmsa, L, Q)
    js = jplm._plm_fused_state0(jmsa, jw, jlam, jlam, L, Q, M)
    tmsa, tw = torch.tensor(msa), torch.tensor(w)
    tx, tm = tplm._fused_inputs(tmsa, L, Q)
    ts = tplm._plm_fused_state0(tmsa, tw, lam, lam, L, Q, M)
    jax_states, port_states = [jax.device_get(js)], [_snapshot(ts)]
    for _ in range(5):
        js = jplm._plm_fused_steps(js, x1h, maskq, jw, jlam, jlam, L, Q, 1)
        tplm._plm_fused_steps(ts, tx, tm, tw, lam, lam, L, Q, 1)
        jax_states.append(jax.device_get(js))
        port_states.append(_snapshot(ts))
    return dict(jax=jax_states, port=port_states, msa=msa, w=w, lam=lam,
                x1h=x1h, maskq=maskq)


def _snapshot(st):
    return dict(f=float(st.f), theta=st.x.clone().numpy(), k=st.k,
                n_evals=st.n_evals, gg=float(st.gg))


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4, 5])
def test_fused_state_matches_jax(trajectories, k):
    js, ts = trajectories["jax"][k], trajectories["port"][k]
    assert ts["k"] == int(js.k) == k
    assert ts["n_evals"] == int(js.n_evals)
    # float32 loop state: drift from reassociated sums stays below these
    np.testing.assert_allclose(ts["f"], float(js.f), rtol=1e-4)
    theta_j = np.concatenate([np.asarray(js.x[0]), np.asarray(js.x[1])])
    if k == 0:
        np.testing.assert_allclose(ts["theta"], theta_j, rtol=1e-5, atol=1e-6)
    else:
        assert rel_l2(ts["theta"], theta_j) <= 1e-3


def test_one_step_from_converted_jax_state(trajectories):
    """Both packages step once from the SAME iterate (k = 3): per-step
    error, free of the drift a longer run accumulates."""
    t = trajectories
    j3 = t["jax"][3]
    ts = tplm.fused_state_from_numpy(j3._asdict(), "cpu")
    assert ts.k == 3 and ts.z.shape == (2 * M, ts.x.shape[0])
    j4 = jplm._plm_fused_steps(
        jax.tree_util.tree_map(jnp.asarray, j3), t["x1h"], t["maskq"],
        jnp.asarray(t["w"]), jnp.float32(t["lam"]), jnp.float32(t["lam"]),
        L, Q, 1,
    )
    tx, tm = tplm._fused_inputs(torch.tensor(t["msa"]), L, Q)
    tplm._plm_fused_steps(ts, tx, tm, torch.tensor(t["w"]), t["lam"], t["lam"], L, Q, 1)
    assert ts.k == int(j4.k) == 4
    assert ts.n_evals == int(j4.n_evals)
    # from the same iterate only this step's float32 reassociation remains
    np.testing.assert_allclose(float(ts.f), float(j4.f), rtol=1e-5)
    theta_j = np.concatenate([np.asarray(j4.x[0]), np.asarray(j4.x[1])])
    assert rel_l2(ts.x.numpy(), theta_j) <= 1e-4
    # the new Gram row: scalar identities here, direct D-length float32 dots
    # in JAX (entries up to ~5e4; they agree to ~3e-6 relative)
    np.testing.assert_allclose(ts.zzt.numpy(), np.asarray(j4.zzt), rtol=1e-4)


def test_full_fit_meets_rank_bar():
    """100 iterations on both sides: FN-APC Spearman >= 0.98 and top-20
    overlap >= 0.9 (the JAX package's own bar, test_ref_parity.py:283-284)."""
    n, l, q = 400, 30, 5
    codes, _ = planted_family(n, l, q, seed=7, n_pairs=8, n_ancestors=16)
    msa = codes.astype(np.int32)
    w = np.asarray(jstats.sequence_weights(jnp.asarray(msa), 0.8, q), np.float32)
    lam = np.float32(0.2 * (l - 1))
    p = l * (l - 1) // 2
    rj = jplm.fit_plm(jnp.asarray(msa), jnp.asarray(w), jnp.float32(lam),
                      jnp.float32(lam), l, q, max_iterations=100)
    rt = tplm.fit_plm(torch.tensor(msa), torch.tensor(w), lam, lam, l, q,
                      max_iterations=100)
    blocks_j = np.asarray(rj.x)[l * q :].reshape(p, q, q)[:, : q - 1, : q - 1]
    apc_j = jscore.apc(jscore.frobenius_norms(jnp.asarray(blocks_j)), l)
    blocks_t = rt.x[l * q :].reshape(p, q, q)[:, : q - 1, : q - 1]
    apc_t = tscore.apc(tscore.frobenius_norms(blocks_t), l)
    sj = jscore.sorted_scores(np.asarray(apc_j), l)
    st = tscore.sorted_scores(apc_t, l)
    assert spearman(st, sj, l) >= 0.98
    assert top_k_overlap(st, sj, 20) >= 0.9
    assert rt.host_syncs >= rt.num_iters  # one read per iteration at least


def test_chunks_and_progress_fn_do_not_change_the_fit():
    """Chunked fits call progress_fn once per chunk and reach the same
    iterate as one chunk (the loop is deterministic on the CPU)."""
    codes, _ = planted_family(150, 16, 5, seed=2, n_pairs=3, n_ancestors=6)
    msa = torch.tensor(codes)
    w = tstats.sequence_weights(msa, 0.8, 5)
    lam = 0.2 * 15
    seen = []
    chunked = tplm.fit_plm(msa, w, lam, lam, 16, 5, max_iterations=12,
                           chunk_size=5, progress_fn=lambda st: seen.append(st.k))
    whole = tplm.fit_plm(msa, w, lam, lam, 16, 5, max_iterations=12, chunk_size=None)
    assert seen == [5, 10, 12]
    assert chunked.num_iters == whole.num_iters == 12
    assert torch.equal(chunked.x, whole.x)
    assert (chunked.fx, chunked.n_evals) == (whole.fx, whole.n_evals)
