"""The port's one parameter space against the JAX package's w2 space.

The port fits the compact reference layout only; ``param_space`` is
accepted for the JAX signatures, and ``"w2"`` fits the compact layout
with a warning.  Each result is held against the JAX w2 functions on the
same numpy-seeded inputs, on the CPU.  Tolerances: losses at float32
tolerance (rtol 1e-6, as ``tests/test_plm_w2.py``); the JAX w2 gradient
pulled back to pairs against the port's compact one (fields rtol 1e-5,
couplings rtol 1e-4: another summation order); fits at the JAX test's bars
(fx rtol 1e-6 against both optima, theta rtol 1e-2 / atol 2e-3); every
``param_space`` name gives the default fit bit for bit.
"""

import logging

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pydca_tpu import plm as jplm
from pydca_tpu_torch import plm as tplm


def _toy(n=60, l=9, q=5, seed=3):
    """``tests/test_plm_w2.py::_toy``."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, q, (4, l))
    msa = base[rng.integers(0, 4, n)]
    mut = rng.random((n, l)) < 0.25
    return np.where(mut, rng.integers(0, q, (n, l)), msa).astype(np.int32)


def _random_theta(l, q, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    d = l * q + (l * (l - 1) // 2) * q * q
    return rng.normal(scale=scale, size=d).astype(np.float32)


Q = pytest.mark.parametrize("q", [5, 21])


def jax_w2_inputs(msa, l, q):
    """The JAX w2 loss's one-hot ``(N, L*q)``, its ``(N, q*L)`` pick mask
    as float32, and the pick mask."""
    x3, maskq = jplm._prep_msa(jnp.asarray(msa), l, q, jnp.float32)
    return x3.reshape(-1, l * q), maskq.astype(jnp.float32).reshape(-1, q * l), maskq


@Q
def test_w2_loss_matches_compact_loss(q):
    """JAX's w2 loss at ``theta_to_z(theta)`` equals the port's compact
    loss at ``theta``: the two spaces hold one objective."""
    msa = _toy(q=q)
    n, l = msa.shape
    w = np.random.default_rng(1).random(n).astype(np.float32)
    lam = np.float32(1.7)
    theta = _random_theta(l, q, seed=2)
    x, xa, maskq = jax_w2_inputs(msa, l, q)
    jw, jl = jnp.asarray(w), jnp.float32(lam)
    z = jplm.theta_to_z(jnp.asarray(theta), l, q)
    f_jax_w2 = jplm._plm_loss_w2_prepped(z, x, xa, maskq, jw, jl, jl, l, q)
    f_port, _ = tplm.plm_loss_and_grad(torch.tensor(theta), torch.tensor(msa), torch.tensor(w),
                                       float(lam), float(lam), l, q)
    np.testing.assert_allclose(float(f_port), float(f_jax_w2), rtol=1e-6)


@Q
def test_w2_gradient_is_exact_subspace_projection(q):
    """JAX's w2 gradient (its custom VJP's projection onto the symmetric
    zero-diagonal subspace) pulled back to pairs is the port's compact
    gradient: the fields equal, and each pair's coupling twice what
    ``z_to_theta`` gives, since the two mirrored entries each carry the
    average."""
    msa = _toy(q=q, seed=5)
    n, l = msa.shape
    w = np.random.default_rng(2).random(n).astype(np.float32)
    lam = np.float32(1.1)
    theta = _random_theta(l, q, seed=4)
    x, xa, maskq = jax_w2_inputs(msa, l, q)
    jw, jl = jnp.asarray(w), jnp.float32(lam)
    g_jax = jax.grad(jplm._plm_loss_w2_prepped)(
        jplm.theta_to_z(jnp.asarray(theta), l, q), x, xa, maskq, jw, jl, jl, l, q)
    as_theta = np.asarray(jplm.z_to_theta(g_jax, l, q))
    _, g = tplm.plm_loss_and_grad(torch.tensor(theta), torch.tensor(msa), torch.tensor(w),
                                  float(lam), float(lam), l, q)
    g = g.numpy()
    np.testing.assert_allclose(g[: l * q], as_theta[: l * q], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g[l * q :], 2.0 * as_theta[l * q :], rtol=1e-4, atol=1e-5)


def fit_inputs(n, l, seed):
    msa = _toy(n=n, l=l, q=5, seed=seed)
    return msa, np.ones((n,), np.float32), np.float32(0.2 * (l - 1))


def test_fit_w2_reaches_compact_optimum():
    """The strictly convex objective's optimum from both layouts: the
    port's w2 fit against the JAX compact and w2 fits (300 iterations at
    most), the result back in the compact layout."""
    q, l = 5, 8
    msa, w, lam = fit_inputs(80, l, 8)
    jargs = (jnp.asarray(msa), jnp.asarray(w), jnp.float32(lam), jnp.float32(lam), l, q)
    r_c = jplm.fit_plm(*jargs, max_iterations=300, param_space="compact")
    r_jz = jplm.fit_plm(*jargs, max_iterations=300, param_space="w2")
    r_z = tplm.fit_plm(torch.tensor(msa), torch.tensor(w), float(lam), float(lam), l, q,
                       max_iterations=300, param_space="w2")
    assert r_z.x.shape == r_c.x.shape
    np.testing.assert_allclose(r_z.fx, float(r_c.fx), rtol=1e-6)
    np.testing.assert_allclose(r_z.fx, float(r_jz.fx), rtol=1e-6)
    np.testing.assert_allclose(r_z.x.numpy(), np.asarray(r_c.x), rtol=1e-2, atol=2e-3)
    np.testing.assert_allclose(r_z.x.numpy(), np.asarray(r_jz.x), rtol=1e-2, atol=2e-3)


def messages(caplog):
    return [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]


@pytest.mark.parametrize("route", ["fused", "streamed"])
@pytest.mark.parametrize("space", ["auto", "compact", "w2"])
def test_param_space_names_fit_compact(space, route, caplog):
    """Every name the JAX package takes gives the default fit, bit for
    bit, on both routes; ``w2`` logs one warning and the others none.
    Any other name raises with the JAX package's message."""
    l, q = 8, 5
    msa, w, lam = fit_inputs(40, l, 10)
    targs = (torch.tensor(msa), torch.tensor(w), float(lam), float(lam), l, q)
    kw = dict(max_iterations=10, seq_block=16 if route == "streamed" else None)
    r_default = tplm.fit_plm(*targs, **kw)
    with caplog.at_level(logging.WARNING, logger="pydca_tpu_torch.plm"):
        r = tplm.fit_plm(*targs, param_space=space, **kw)
    got = messages(caplog)
    assert len(got) == (space == "w2")
    if got:
        assert "compact parameter layout" in got[0]
    assert torch.equal(r.x, r_default.x) and r.fx == r_default.fx
    assert r.num_iters == r_default.num_iters and r.n_evals == r_default.n_evals
    with pytest.raises(jplm.PlmDCAException) as jerr:
        jplm._resolve_param_space(space + "x", l, q, 5, False)
    with pytest.raises(tplm.PlmDCAException) as terr:
        tplm.fit_plm(*targs, param_space=space + "x", **kw)
    assert str(terr.value) == str(jerr.value)
