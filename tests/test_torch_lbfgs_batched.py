"""Port's lock-step L-BFGS loop (``lbfgs_init_batch``/``lbfgs_steps_batch``)
against the port's sequential generic loop, lane by lane, on the CPU, and
the resumable strong-Wolfe search (``wolfe_search``) against the JAX
package's ``wolfe_scalar``.

Each lane of a batch must make the decisions of its own sequential run:
the same iterations, evaluations and flags, the iterate at relative L2
<= 1e-5 (the loop's dots and combines are batched products, summed in
another order than the sequential loop's).  The lanes: quadratics
``(x - b) A (x - b) / 2`` of condition 1 to 30 with their minimum at 0, so
that each decrease stays resolvable in float32 to the end (where a late
decrease is a millionth of the value, any two summation orders can flip a
decision), one whose search fails and one that stops at the rounding exit;
and the toy plm families of ``tests/test_family.py`` at the block shape.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pydca_tpu_torch.family as tfam
from pydca_tpu.ops import lbfgs as jl
from pydca_tpu_torch.ops import lbfgs as tl
from test_torch_family import BATCHES
from test_torch_lbfgs import flat, jump, quadratic, wiggly

D = 300


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def vector_lanes():
    """Per-lane objectives ``x (D,) -> (f, g)`` and starting points."""
    rng = np.random.default_rng(7)
    objs = []
    for c in (0.0, 0.5, 1.0, 1.5):  # condition 1, 3, 10, 30
        a = torch.tensor(np.logspace(0, c, D), dtype=torch.float32)
        b = torch.tensor(rng.normal(size=D), dtype=torch.float32)
        objs.append(lambda x, a=a, b=b: (0.5 * ((x - b) * a * (x - b)).sum(), a * (x - b)))
    x_fail = torch.tensor(rng.normal(size=D), dtype=torch.float32)
    c = torch.tensor(rng.normal(size=D), dtype=torch.float32)
    # the gradient says descend, every step jumps up by 1: the search fails
    objs.append(lambda x: (5.0 + (x != x_fail).any().float(), c.clone()))
    # decreases below float32 resolution of f: the rounding exit
    objs.append(lambda x: (1.0e4 + 1.0e-9 * (c * x).sum(), 1.0e-9 * c))
    x0 = torch.tensor(rng.normal(size=(len(objs), D)), dtype=torch.float32)
    x0[4] = x_fail
    return objs, x0


def batch_fun(objs, calls=None):
    def fun(x, lanes):
        if calls is not None:
            calls.append(lanes.tolist())
        fs, gs = zip(*(objs[i](row) for i, row in zip(lanes.tolist(), x)))
        return torch.stack(fs), torch.stack(gs)
    return fun


def plm_lanes():
    codes = [torch.from_numpy(c) for c in BATCHES["toy"]]
    w = [torch.ones(c.shape[0]) / 2 for c in codes]
    lam = np.asarray([0.2 * (c.shape[1] - 1) for c in codes], np.float32)
    fun, x0, _ = tfam._lockstep_problem(codes, w, lam, lam, 5)
    return fun, x0


def lane_fun(fun, i, device="cpu"):
    lanes = torch.tensor([i], device=device)
    return lambda x: tuple(t[0] for t in fun(x[None], lanes))


def sequential(fun1, x0, iters):
    st = tl.lbfgs_init(fun1, x0.clone())
    return tl.lbfgs_steps(fun1, st, iters)


def flags(st):
    return st.k, st.n_evals, st.done, st.converged, st.ls_failed


@pytest.mark.parametrize("case", ["vector", "plm"])
def test_lanes_equal_their_sequential_runs(case):
    if case == "vector":
        objs, x0 = vector_lanes()
        fun, iters = batch_fun(objs), 100
        one = lambda i: objs[i]
    else:
        fun, x0 = plm_lanes()
        iters = 10
        one = lambda i: lane_fun(fun, i)
    st = tl.lbfgs_init_batch(fun, x0.clone())
    tl.lbfgs_steps_batch(fun, st, iters)
    assert len(st.f) == x0.shape[0]
    seen = set()
    for i in range(x0.shape[0]):
        lane, ref = st.lane(i), sequential(one(i), x0[i], iters)
        assert flags(lane) == flags(ref), i
        assert rel_l2(lane.x, ref.x) <= 1e-5
        assert lane.f == pytest.approx(float(ref.f), rel=1e-5, abs=1e-6)
        np.testing.assert_array_equal(lane.rho.numpy() != 0, ref.rho.numpy() != 0)
        seen.add((lane.converged, lane.ls_failed))
    if case == "vector":
        # the lanes end in each way a search can end
        assert seen == {(True, False), (False, True)}
        assert [st.lane(i).k for i in range(4)] == sorted(st.lane(i).k for i in range(4))
        assert st.lane(5).k == 0 and st.lane(5).converged


def test_finished_lane_is_left_bit_for_bit():
    """A lane that is done keeps its iterate, gradient, history and
    counters bit for bit while the others run, and is never evaluated
    again."""
    objs, x0 = vector_lanes()
    calls = []
    fun = batch_fun(objs, calls)
    st = tl.lbfgs_init_batch(fun, x0.clone())
    snaps = {}
    for it in range(40):
        calls.clear()
        tl.lbfgs_steps_batch(fun, st, 1)
        for i, snap in snaps.items():
            assert all(i not in lanes for lanes in calls)
            lane = st.lane(i)
            for name in ("x", "g", "z", "rho"):
                assert torch.equal(getattr(lane, name), snap[name]), (i, name)
            assert (lane.f, flags(lane)) == (snap["f"], snap["flags"])
        for i in range(len(st.f)):
            lane = st.lane(i)
            if lane.done and i not in snaps:
                snaps[i] = dict(x=lane.x.clone(), g=lane.g.clone(), z=lane.z.clone(),
                                rho=lane.rho.clone(), f=lane.f, flags=flags(lane))
    assert len(snaps) == len(st.f)  # every lane finished, at different iterations
    assert len({s["flags"][0] for s in snaps.values()}) >= 4


@pytest.mark.parametrize("case", ["vector", "plm"])
@pytest.mark.parametrize("nl", [1, 2, 5, 9])
def test_one_read_a_round_whatever_the_lane_count(case, nl):
    """F copies of one lane make the reads of one sequential run: each
    round's read serves every lane."""
    if case == "vector":
        objs, x0 = vector_lanes()
        obj, x1, iters = objs[2], x0[2], 100
    else:
        fun_p, x0 = plm_lanes()
        obj, x1, iters = lane_fun(fun_p, 0), x0[0], 8
    ref = sequential(obj, x1, iters)
    fun = batch_fun([obj] * nl)
    st = tl.lbfgs_init_batch(fun, x1.repeat(nl, 1))
    tl.lbfgs_steps_batch(fun, st, iters)
    assert st.host_syncs == ref.host_syncs
    assert st.lane_iterations == nl * (ref.k + (not ref.converged and ref.done))
    assert all(flags(st.lane(i)) == flags(ref) for i in range(nl))


@pytest.mark.parametrize("nl", [1, 8, 11])
def test_lane_products_and_solves_are_each_lanes_own(nl):
    """The grouped flat GEMM (groups of ``_LANE_GROUP`` lanes, the last one
    partial) against each lane's own product, and the host solves against
    one ``torch.linalg.solve`` a lane, bit for bit."""
    rng = np.random.default_rng(nl)
    a = torch.tensor(rng.normal(size=(nl, 10, 257)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(nl, 5, 257)), dtype=torch.float32)
    got = tl._lane_products(a, b)
    assert got.shape == (nl, 10, 5)
    for f in range(nl):
        np.testing.assert_allclose(got[f].numpy(), (a[f] @ b[f].T).numpy(), rtol=1e-5, atol=1e-4)
    r = torch.tensor(rng.normal(size=(nl, 5, 5)) + 4 * np.eye(5), dtype=torch.float32)
    p = torch.tensor(rng.normal(size=(nl, 5)), dtype=torch.float32)
    x = tl._host_solve(r, p)
    assert all(torch.equal(x[f], torch.linalg.solve(r[f], p[f])) for f in range(nl))
    assert torch.equal(tl._host_solve(r[0], p[0]), x[0])


@pytest.mark.parametrize(
    "make_phi,f0,dg0,step0",
    [
        (quadratic, 4.0, -4.0, 1.0),
        (quadratic, 4.0, -4.0, 0.01),
        (quadratic, 4.0, -4.0, 30.0),
        (wiggly, 0.0, -3.0, 2.5),
        (jump, 4.0, -1.0, 1.0),
        (flat, 1.0e4, -1.0e-9, 1.0),
    ],
)
def test_wolfe_search_drives_the_old_decisions(make_phi, f0, dg0, step0):
    """``tests/test_torch_lbfgs.py``'s cases through the generator itself
    and through ``wolfe_scalar``: the same trials, the JAX package's
    result, and ``kept`` exactly on the trials that became the best."""
    phi = make_phi(np)
    jphi = make_phi(jnp)
    want = jl.wolfe_scalar(
        lambda a: tuple(jnp.asarray(v, jnp.float32) for v in jphi(a)),
        jnp.float32(f0), jnp.float32(dg0), jnp.float32(step0),
        jnp.float32(1e-4), jnp.float32(0.9), 10,
    )
    search = tl.wolfe_search(f0, dg0, step0, 1e-4, 0.9, 10)
    trials, kept_at, reply = [], [], None
    while True:
        try:
            alpha, kept = search.send(reply)
        except StopIteration as stop:
            *result, kept = stop.value
            kept_at.append(kept)
            break
        kept_at.append(kept)
        reply = tuple(np.float32(v) for v in phi(alpha))
        trials.append((alpha, reply[0]))
    alpha, f_new, took, rounding, n = result
    assert kept_at[0] is False and n == len(trials)
    assert (took, rounding, n) == (bool(want[2]), bool(want[3]), int(want[4]))
    np.testing.assert_allclose(float(alpha), float(want[0]), rtol=1e-5)
    np.testing.assert_allclose(float(f_new), float(want[1]), rtol=1e-5)
    if took:  # the best trial is the last one kept
        best = max(t for t in range(n) if kept_at[t + 1])
        assert (trials[best][0], trials[best][1]) == (alpha, f_new)

    calls, best_calls = [], []
    got = tl.wolfe_scalar(
        lambda a: calls.append(a) or tuple(np.float32(v) for v in phi(a)),
        f0, dg0, step0, 1e-4, 0.9, 10, on_best=lambda: best_calls.append(len(calls)),
    )
    assert tuple(got) == tuple(result)
    assert calls == [a for a, _ in trials]
    assert best_calls == [t + 1 for t in range(n) if kept_at[t + 1]]
