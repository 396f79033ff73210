"""Port's scalar L-BFGS machinery vs ``pydca_tpu.ops.lbfgs``.

Histories are built as in ``tests/test_plm.py`` (partial, full and wrapped
circular buffers); both sides run in float32.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pydca_tpu.ops import lbfgs as jl
from pydca_tpu_torch.ops import lbfgs as tl


def history(k, m=5, dsz=300, seed=11):
    rng = np.random.default_rng(seed + k)
    s_hist = np.zeros((m, dsz))
    y_hist = np.zeros((m, dsz))
    for t in range(max(0, k - m), k):
        slot = t % m
        s = rng.normal(size=dsz)
        y = s * rng.uniform(0.5, 2.0) + 0.1 * rng.normal(size=dsz)
        if s @ y <= 0:
            y = s  # keep curvature positive
        s_hist[slot] = s
        y_hist[slot] = y
    g = rng.normal(size=dsz)
    z = np.concatenate([s_hist, y_hist], axis=0)
    return (z @ g).astype(np.float32), (z @ z.T).astype(np.float32), np.float32(g @ g)


@pytest.mark.parametrize("k", [0, 1, 3, 5, 9, 17])
def test_direction_coeffs_match_jax(k):
    m = 5
    zg, zzt, gg = history(k, m)
    want = jl.direction_coeffs(
        jnp.asarray(zg), jnp.asarray(zzt), jnp.asarray(gg),
        jnp.asarray(k, jnp.int32), m,
    )
    got = tl.direction_coeffs(torch.tensor(zg), torch.tensor(zzt), torch.tensor(gg), k, m)
    for name, a, b in zip(("gamma", "cfull", "dg0", "dnorm2"), got, want):
        # float32 LU solves of a <= 5 x 5 triangular system on both sides
        np.testing.assert_allclose(
            np.asarray(a, np.float32), np.asarray(b), rtol=1e-5, atol=1e-6,
            err_msg=f"{name}, k={k}",
        )


def quadratic(xp):
    return lambda a: ((a - 2.0) ** 2, 2.0 * (a - 2.0))


def wiggly(xp):
    # non-convex along the line: cubic interpolation and zoom flips
    return lambda a: (0.5 * a * a - xp.sin(3.0 * a), a - 3.0 * xp.cos(3.0 * a))


def jump(xp):
    # descends at 0 but jumps up by 1 for every a > 0: the search fails
    return lambda a: (5.0 + a, 1.0 + 0.0 * a)


def flat(xp):
    # decrease below float32 resolution of f0: the rounding exit
    return lambda a: (1.0e4 - 1.0e-9 * a, -1.0e-9 + 0.0 * a)


@pytest.mark.parametrize(
    "make_phi,f0,dg0,step0",
    [
        (quadratic, 4.0, -4.0, 1.0),  # accepted at the first trial
        (quadratic, 4.0, -4.0, 0.01),  # bracket expansion by 2.1
        (quadratic, 4.0, -4.0, 30.0),  # overshoot: zoom
        (wiggly, 0.0, -3.0, 2.5),  # zoom with cubic steps
        (jump, 4.0, -1.0, 1.0),  # line search fails
        (flat, 1.0e4, -1.0e-9, 1.0),  # float32 rounding exit
    ],
)
def test_wolfe_scalar_matches_jax(make_phi, f0, dg0, step0):
    jphi = make_phi(jnp)
    want = jl.wolfe_scalar(
        lambda a: tuple(jnp.asarray(v, jnp.float32) for v in jphi(a)),
        jnp.float32(f0), jnp.float32(dg0), jnp.float32(step0),
        jnp.float32(1e-4), jnp.float32(0.9), 10,
    )
    tphi = make_phi(np)
    got = tl.wolfe_scalar(
        lambda a: tuple(np.float32(v) for v in tphi(a)),
        f0, dg0, step0, 1e-4, 0.9, 10,
    )
    alpha, f_new, took, rounding, trials = got
    # same float32 decisions: identical trial counts and flags; the step
    # and value agree to float32 rounding of sin/cos between libraries
    assert (took, rounding, trials) == (bool(want[2]), bool(want[3]), int(want[4]))
    np.testing.assert_allclose(float(alpha), float(want[0]), rtol=1e-5)
    np.testing.assert_allclose(float(f_new), float(want[1]), rtol=1e-5)


def test_cubic_step_matches_jax():
    args = [np.float32(v) for v in (0.0, 1.0, -2.0, 2.0, 0.5, 1.0, 0.0, 2.0)]
    want = float(jl._cubic_step(*[jnp.float32(a) for a in args]))
    np.testing.assert_allclose(float(tl._cubic_step(*args)), want, rtol=1e-6)
