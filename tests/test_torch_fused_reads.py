"""The fused plmDCA loop's reads (``plm._plm_fused_steps``).

The direction's coefficients (``ops.lbfgs.direction_coeffs``) and the
history Gram's border run on the fit's device, so that each step ends with
one read, which also returns the next step's direction dots and its first
line-search trial (alpha = 1), launched behind the gradient.  A call's
first step reads its dots and first trial on their own; its last step
queues nothing.  A queued trial is thrown away (``discarded_trials``) when
the fit stops on the gradient test, or when the next step takes the
steepest-descent fallback.  On the CPU the queued steps are bit for bit the
steps read one value set at a time.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from pydca_tpu_torch import plm as tplm
from pydca_tpu_torch import stats as tstats
from pydca_tpu_torch.ops import lbfgs as tl
from pydca_tpu_torch.synthetic import planted_family

N, L, Q, M, ITERS = 150, 16, 5, 5, 12
LAM = 0.2 * (L - 1)

# what each read of the fused loop returns, by its size: the start state
# (nll, |h|^2, |g|^2), a direction's five dots, one trial's two sums, the
# step-ending read (|g'|^2, the next direction's dots, its first trial), a
# call's last step (|g'|^2), and the steepest-descent fallback's four dots
INIT, DOTS, TRIAL, AHEAD, LAST, FALLBACK = 3, 5, 2, 8, 1, 4


@pytest.fixture(scope="module")
def problem():
    codes, _ = planted_family(N, L, Q, seed=2, n_pairs=3, n_ancestors=6)
    msa = torch.tensor(codes)
    return msa, tstats.sequence_weights(msa, 0.8, Q)


def read_sizes(monkeypatch):
    """Record the number of values of every read the loop makes."""
    sizes = []
    real = tl._read_f32

    def reading(*vals):
        out = real(*vals)
        sizes.append(len(out))
        return out

    monkeypatch.setattr(tl, "_read_f32", reading)
    return sizes


def fused_fit(problem, calls, epsilon=1e-3):
    """A fused fit from the start, advanced by one ``_plm_fused_steps``
    call of each size in ``calls``."""
    msa, w = problem
    st = tplm._plm_fused_state0(msa, w, LAM, LAM, L, Q, M, epsilon=epsilon)
    x1h, codes = tplm._fused_inputs(msa, L, Q)
    for n in calls:
        tplm._plm_fused_steps(st, x1h, codes, w, LAM, LAM, L, Q, n, epsilon=epsilon)
    return st


@pytest.mark.parametrize("calls", [[12], [5, 5, 2], [4, 4, 4], [1] * 12],
                         ids=["one", "fives", "fours", "ones"])
def test_reads_of_a_fit_that_hits_its_cap(problem, monkeypatch, calls):
    """Init, one read a step, one for each trial after a step's first, and
    a call's first step's dots and first trial: ``n_evals + 2 x calls``."""
    sizes = read_sizes(monkeypatch)
    st = fused_fit(problem, calls)
    assert st.k == ITERS and not st.done and st.discarded_trials == 0
    assert st.host_syncs == len(sizes) == st.n_evals + 2 * len(calls)
    ahead = ITERS - len(calls)  # the steps whose values came with the step before
    assert Counter(sizes) == {k: v for k, v in {
        INIT: 1, DOTS: len(calls), TRIAL: st.n_evals - 1 - ahead, AHEAD: ahead,
        LAST: len(calls)}.items() if v}


def test_one_read_a_step_is_the_fit_of_one_step_a_call(problem):
    """The queued directions and trials change no value: twelve steps in
    one call equal twelve calls of one step, bit for bit."""
    whole, ones = fused_fit(problem, [ITERS]), fused_fit(problem, [1] * ITERS)
    for name in ("x", "g", "z", "zzt", "zg", "logits", "picked"):
        assert torch.equal(getattr(whole, name), getattr(ones, name)), name
    for name in ("f", "gg", "xx", "rh", "rj", "k", "n_evals"):
        assert getattr(whole, name) == getattr(ones, name), name
    assert (whole.host_syncs, ones.host_syncs) == (whole.n_evals + 2, ones.n_evals + 2 * ITERS)


def test_a_fit_that_stops_on_the_gradient_test_discards_one_trial(problem, monkeypatch):
    sizes = read_sizes(monkeypatch)
    st = fused_fit(problem, [40], epsilon=0.05)
    assert st.converged and st.done and st.k < 40 and not st.ls_failed
    assert st.discarded_trials == 1
    assert st.host_syncs == st.n_evals + 2
    assert sizes[-1] == AHEAD  # the stopping step's read carried the next trial
    # the same fit, each step read on its own, stops at the same step
    ones = fused_fit(problem, [1] * 40, epsilon=0.05)
    assert (ones.k, ones.n_evals, ones.discarded_trials) == (st.k, st.n_evals, 0)
    assert torch.equal(ones.x, st.x)


def test_the_fallback_discards_the_queued_trial(problem, monkeypatch):
    """A queued direction that is not a descent direction takes the
    steepest-descent fallback: its first trial goes, the fallback reads
    its four dots and the first trial along -g on its own."""
    real = tplm.direction_coeffs

    def ascent_at_3(zg, zzt, gg, k, m):
        gamma, cfull, dg0, dn2 = real(zg, zzt, gg, k, m)
        return (-gamma, -cfull, dg0, dn2) if k == 3 else (gamma, cfull, dg0, dn2)

    monkeypatch.setattr(tplm, "direction_coeffs", ascent_at_3)
    ones = fused_fit(problem, [1] * ITERS)
    sizes = read_sizes(monkeypatch)
    st = fused_fit(problem, [ITERS])
    assert st.k == ITERS and st.discarded_trials == 1
    assert Counter(sizes)[FALLBACK] == 1
    assert st.host_syncs == st.n_evals + 2 + 2  # the fallback's dots, the trial alone
    for name in ("x", "zzt", "zg"):
        assert torch.equal(getattr(st, name), getattr(ones, name)), name
    assert st.n_evals == ones.n_evals


def test_fit_result_reports_discarded_trials(problem):
    msa, w = problem
    res = tplm.fit_plm(msa, w, LAM, LAM, L, Q, max_iterations=ITERS, chunk_size=5)
    assert res.discarded_trials == 0 and res.num_iters == ITERS
    assert res.host_syncs == res.n_evals + 2 * 3
    assert tl.LBFGSResult(torch.zeros(1), 0.0, 0.0, 0, False, False, 1).discarded_trials == 0


def _history(k, m=M, dsz=200, seed=5):
    rng = np.random.default_rng(seed + k)
    z = np.zeros((2 * m, dsz))
    for t in range(max(0, k - m), k):
        s = rng.normal(size=dsz)
        z[t % m], z[t % m + m] = s, s * rng.uniform(0.5, 2.0) + 0.1 * rng.normal(size=dsz)
    g = rng.normal(size=dsz)
    return (torch.tensor((z @ g).astype(np.float32)), torch.tensor((z @ z.T).astype(np.float32)),
            np.float32(g @ g))


@pytest.mark.parametrize("k", [0, 1, 4, 5, 8, 13])
@pytest.mark.parametrize("descent", [True, False], ids=["descent", "collapse"])
def test_direction_coeffs_take_a_host_or_tensor_gg(k, descent):
    """The fused loop passes ``||g||^2`` as the host's float32 (a call's
    first step) or as the device's 0-d tensor (a step queued ahead): the
    coefficients are the same; a direction that does not descend (here
    made so by a negative ``gg``) collapses to ``(1, 0, -gg, gg)``."""
    zg, zzt, gg = _history(k)
    if not descent:
        gg = np.float32(-gg * 1e3)
    got = tl.direction_coeffs(zg, zzt, gg, k, M)
    for a, b in zip(got, tl.direction_coeffs(zg, zzt, torch.tensor(gg), k, M)):
        assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)
    assert bool(got[2] < 0) == descent
    if not descent:
        assert float(got[0]) == 1.0 and not got[1].any()
        assert (float(got[2]), float(got[3])) == (-gg, gg)


def test_the_previous_image_is_freed_before_the_next_is_made(problem, monkeypatch):
    """The queued step's direction image ``u`` (an ``(N, q, L)`` tensor) is
    dropped once its gradient is taken: when the next step's image is
    made, behind that gradient, no earlier one is alive, so that two never
    share the card's memory."""
    import weakref

    made = []
    real = tplm._logits_mm

    def logits_mm(*args, **kw):
        assert all(r() is None for r in made), "an earlier direction image is alive"
        out = real(*args, **kw)
        made.append(weakref.ref(out))
        return out

    msa, w = problem
    st = tplm._plm_fused_state0(msa, w, LAM, LAM, L, Q, M)
    x1h, codes = tplm._fused_inputs(msa, L, Q)
    monkeypatch.setattr(tplm, "_logits_mm", logits_mm)
    for n in (7, 5):
        tplm._plm_fused_steps(st, x1h, codes, w, LAM, LAM, L, Q, n)
    assert st.k == ITERS and len(made) == ITERS


@pytest.mark.parametrize("part", ["coeffs", "coeffs_collapse", "finish", "history",
                                  "history_fallback", "history_bf16"])
def test_the_algebra_wrappers_take_their_plain_versions_on_the_cpu(part):
    """On CPU tensors each L-BFGS wrapper of ``ops.cuda_kernels`` is its
    plain version, bit for bit, and counts no kernel launch."""
    from pydca_tpu_torch.ops import cuda_kernels as ck

    k = 8
    zg, zzt, gg = _history(k)
    before = (ck.lbfgs_coeffs.launches, ck.lbfgs_history.launches, ck.lbfgs_finish.launches)
    if part.startswith("coeffs"):
        if part == "coeffs_collapse":
            gg = np.float32(-gg * 1e3)
        got, want = ck.lbfgs_coeffs(zg, zzt, gg, k, M), ck.lbfgs_coeffs_reference(zg, zzt, gg, k, M)
        assert got.shape == (2 * M + 3,) and torch.equal(got, want)
        gamma, cfull, dg0, dn2 = tl.direction_coeffs(zg, zzt, gg, k, M)
        assert torch.equal(got, torch.cat([torch.stack([gamma, dg0, dn2]), cfull]))
    elif part == "finish":
        gen = torch.Generator().manual_seed(3)
        d, g, gamma = torch.randn(50, generator=gen), torch.randn(50, generator=gen), \
            torch.tensor(0.37)
        want = d.clone().add_(g, alpha=float(gamma)).neg_()
        assert torch.equal(ck.lbfgs_finish(d, g, gamma), want) and torch.equal(d, want)
    else:
        gen = torch.Generator().manual_seed(4)
        dim = 300
        z = torch.randn(2 * M, dim, generator=gen)
        if part == "history_bf16":
            z = z.to(torch.bfloat16)
        g, g_new = torch.randn(dim, generator=gen), torch.randn(dim, generator=gen)
        zg, zzt = ck._hist_dot(z, g), z.float() @ z.float().T
        gamma, cfull, dg0, dn2 = tl.direction_coeffs(zg, zzt, float(g @ g), k, M)
        d = -(gamma * g + cfull @ z.float())
        coeffs = None if part == "history_fallback" else (gamma, cfull)
        if coeffs is None:
            d = -g
        args = (k, np.float32(0.5), np.float32(float(g @ d)), np.float32(float(d @ d)),
                np.float32(float(g @ g)), coeffs)
        z1, z2 = z.clone(), z.clone()
        got = ck.lbfgs_history(z1, zzt, zg, g, d, g_new, *args)
        want = ck.lbfgs_history_reference(z2, zzt, zg, g, d, g_new, *args)
        assert torch.equal(z1, z2) and not torch.equal(z1, z) and z1.dtype == z.dtype
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert (ck.lbfgs_coeffs.launches, ck.lbfgs_history.launches,
            ck.lbfgs_finish.launches) == before
