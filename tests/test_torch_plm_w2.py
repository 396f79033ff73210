"""Port's w2 parameter space (``param_space="w2"``) vs ``pydca_tpu.plm``.

Mirrors ``tests/test_plm_w2.py`` with each result held against the JAX
function on the same numpy-seeded inputs, on the CPU.  Tolerances: the
z <-> theta conversions move entries (``z_to_theta`` averages a pair with
its mirror, in the same order), so they are equal bit for bit; losses at
float32 tolerance (rtol 1e-6, as the JAX test); gradients to 1e-6 of the
largest entry (the port reads the mirror as a permutation of the raw
gradient where the JAX full-batch loss computes it as a third product:
another summation order); fits at the JAX test's bars (fx rtol 1e-6
against the compact optimum, theta rtol 1e-2 / atol 2e-3; streaming fx
rtol 1e-4, theta 2e-3).
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


def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@Q
def test_theta_z_round_trip_bitwise(q):
    l = 11
    theta = _random_theta(l, q)
    z = tplm.theta_to_z(torch.tensor(theta), l, q)
    assert z.shape == (l * q + (l * q) ** 2,)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jplm.theta_to_z(jnp.asarray(theta), l, q)))
    np.testing.assert_array_equal(tplm.z_to_theta(z, l, q).numpy(), theta)
    # any z, not only one in the subspace: the averaging is JAX's, bit for bit
    zr = np.random.default_rng(5).normal(size=z.shape).astype(np.float32)
    np.testing.assert_array_equal(tplm.z_to_theta(torch.tensor(zr), l, q).numpy(),
                                  np.asarray(jplm.z_to_theta(jnp.asarray(zr), l, q)))


def jax_w2_inputs(msa, l, q):
    x3, maskq = jplm._prep_msa(jnp.asarray(msa), l, q, jnp.float32)
    return x3, x3.reshape(-1, l * q), maskq.astype(jnp.float32).reshape(-1, q * l), maskq


@Q
def test_w2_loss_matches_compact_loss(q):
    msa = _toy(q=q)
    n, l = msa.shape
    w = np.random.default_rng(1).random(n).astype(np.float32)
    lam = np.float32(1.7)
    theta = _random_theta(l, q, seed=2)
    x3, x, xa, maskq = jax_w2_inputs(msa, l, q)
    jw, jl = jnp.asarray(w), jnp.float32(lam)
    f_compact = jplm._plm_loss_prepped(jnp.asarray(theta), x3, maskq, jw, jl, jl, l, q)
    z = jplm.theta_to_z(jnp.asarray(theta), l, q)
    f_jax_w2 = jplm._plm_loss_w2_prepped(z, x, xa, maskq, jw, jl, jl, l, q)
    tx, tmask = tplm._prep_msa(torch.tensor(msa), l, q)
    f_port, _ = tplm._plm_loss_and_grad_w2_prepped(
        tplm.theta_to_z(torch.tensor(theta), l, q), tx, tmask, torch.tensor(w), float(lam),
        float(lam), l, q)
    np.testing.assert_allclose(float(f_port), float(f_compact), rtol=1e-6)
    np.testing.assert_allclose(float(f_port), float(f_jax_w2), rtol=1e-6)


@Q
def test_w2_gradient_is_exact_subspace_projection(q):
    """The port's g_z against JAX's (its custom VJP's projection), and the
    subspace facts of ``tests/test_plm_w2.py``: h parts equal the compact
    gradient, each coupling slot carries half the compact J gradient, g_z
    is symmetric under the mirror with zero diagonal blocks."""
    msa = _toy(q=q, seed=5)
    n, l = msa.shape
    w = np.random.default_rng(2).random(n).astype(np.float32)
    lam = np.float32(1.1)
    theta = _random_theta(l, q, seed=4)
    x3, x, xa, maskq = jax_w2_inputs(msa, l, q)
    jw, jl = jnp.asarray(w), jnp.float32(lam)
    g_compact = np.asarray(jax.grad(jplm._plm_loss_prepped)(
        jnp.asarray(theta), x3, maskq, jw, jl, jl, l, q))
    g_jax = np.asarray(jax.grad(jplm._plm_loss_w2_prepped)(
        jplm.theta_to_z(jnp.asarray(theta), l, q), x, xa, maskq, jw, jl, jl, l, q))
    tx, tmask = tplm._prep_msa(torch.tensor(msa), l, q)
    _, g = tplm._plm_loss_and_grad_w2_prepped(
        tplm.theta_to_z(torch.tensor(theta), l, q), tx, tmask, torch.tensor(w), float(lam),
        float(lam), l, q)
    g = g.numpy()
    assert max_rel(g, g_jax) <= 1e-6
    np.testing.assert_allclose(g[: l * q], g_compact[: l * q], rtol=1e-5, atol=1e-6)
    as_theta = tplm.z_to_theta(torch.tensor(g), l, q).numpy()
    np.testing.assert_allclose(2.0 * as_theta[l * q :], g_compact[l * q :], rtol=1e-4, atol=1e-5)
    g4 = g[l * q :].reshape(l, q, q, l)
    np.testing.assert_array_equal(g4, g4.transpose(3, 2, 1, 0))
    assert not np.einsum("iabi->iab", g4).any()


@pytest.mark.parametrize("block", [8, 13])
def test_w2_chunked_matches_w2_full(block):
    q = 5
    msa = _toy(n=37, l=8, q=q, seed=6)
    n, l = msa.shape
    w = np.random.default_rng(3).random(n).astype(np.float32)
    lam = np.float32(1.3)
    theta = _random_theta(l, q, seed=7)
    z = jplm.theta_to_z(jnp.asarray(theta), l, q)
    mb, wb = jplm._pad_to_blocks(msa, jnp.asarray(w), block)
    f_jax, g_jax = jplm.plm_loss_and_grad_w2_chunked(z, mb, wb, jnp.float32(lam),
                                                     jnp.float32(lam), l, q)
    tz, tw = torch.tensor(np.asarray(z)), torch.tensor(w)
    f_chk, g_chk = tplm.plm_loss_and_grad_w2_chunked(tz, torch.tensor(msa), tw, float(lam),
                                                     float(lam), l, q, block)
    tx, tmask = tplm._prep_msa(torch.tensor(msa), l, q)
    f_full, g_full = tplm._plm_loss_and_grad_w2_prepped(tz, tx, tmask, tw, float(lam),
                                                        float(lam), l, q)
    np.testing.assert_allclose(float(f_chk), float(f_jax), rtol=1e-6)
    np.testing.assert_allclose(float(f_chk), float(f_full), rtol=1e-6)
    assert max_rel(g_chk.numpy(), g_jax) <= 1e-6
    assert max_rel(g_chk.numpy(), g_full.numpy()) <= 1e-6


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


def test_fit_w2_streaming():
    q, l = 5, 8
    msa, w, lam = fit_inputs(50, l, 9)
    r_jax = jplm.fit_plm(jnp.asarray(msa), jnp.asarray(w), jnp.float32(lam), jnp.float32(lam),
                         l, q, max_iterations=15, seq_block=16, param_space="w2")
    targs = (torch.tensor(msa), torch.tensor(w), float(lam), float(lam), l, q)
    r_full = tplm.fit_plm(*targs, max_iterations=15, param_space="w2")
    r_str = tplm.fit_plm(*targs, max_iterations=15, seq_block=16, param_space="w2")
    assert r_str.num_iters == r_full.num_iters == int(r_jax.num_iters)
    for want in (float(r_full.fx), float(r_jax.fx)):
        np.testing.assert_allclose(r_str.fx, want, rtol=1e-4)
    for want in (r_full.x.numpy(), np.asarray(r_jax.x)):
        np.testing.assert_allclose(r_str.x.numpy(), want, rtol=2e-3, atol=2e-3)


def messages(caplog):
    return [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]


@pytest.mark.parametrize("case", ["bf16", "budget"])
def test_param_space_fallbacks(case, monkeypatch, caplog):
    """``w2`` under bfloat16 products, or past ``W2SPACE_MAX_BYTES``
    (patched down in both packages: (2m + 4) vectors of 4 (Lq + (Lq)^2)
    bytes, 91840 at L = 8, q = 5), resolves to the compact layout with the
    JAX package's warning; the fit is then the compact fit, bit for bit."""
    l, q, m = 8, 5, 5
    bf16 = case == "bf16"
    if not bf16:
        monkeypatch.setattr(jplm, "W2SPACE_MAX_BYTES", 91839)
        monkeypatch.setattr(tplm, "W2SPACE_MAX_BYTES", 91839)
    with caplog.at_level(logging.WARNING):
        assert jplm._resolve_param_space("w2", l, q, m, bf16) is False
        want = messages(caplog)
        caplog.clear()
        assert tplm._resolve_param_space("w2", l, q, m, bf16) is False
        got = messages(caplog)
    assert got == want and len(got) == 1
    assert ("bfloat16" if bf16 else "falling back to compact") in got[0]
    msa, w, lam = fit_inputs(40, l, 10)
    targs = (torch.tensor(msa), torch.tensor(w), float(lam), float(lam), l, q)
    r_w2 = tplm.fit_plm(*targs, max_iterations=10, param_space="w2", mm_bf16=bf16)
    r_c = tplm.fit_plm(*targs, max_iterations=10, param_space="compact", mm_bf16=bf16)
    assert torch.equal(r_w2.x, r_c.x) and r_w2.n_evals == r_c.n_evals
    if not bf16:  # one vector more fits the budget: w2 again
        monkeypatch.setattr(tplm, "W2SPACE_MAX_BYTES", 91840)
        assert tplm._resolve_param_space("w2", l, q, m, False) is True


@pytest.mark.parametrize("space,want", [("auto", False), ("compact", False), ("w2", True)])
def test_resolve_param_space_matches_jax(space, want):
    assert tplm._resolve_param_space(space, 8, 5, 5, False) is want
    assert jplm._resolve_param_space(space, 8, 5, 5, False) is want
    with pytest.raises(jplm.PlmDCAException) as jerr:
        jplm._resolve_param_space(space + "x", 8, 5, 5, False)
    with pytest.raises(tplm.PlmDCAException) as terr:
        tplm._resolve_param_space(space + "x", 8, 5, 5, False)
    assert str(terr.value) == str(jerr.value)
