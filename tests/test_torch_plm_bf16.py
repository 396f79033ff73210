"""Port's bfloat16 logits products and history rows vs ``pydca_tpu.plm``.

``precision="bfloat16"`` rounds both logits products' operands to
bfloat16 (the backward product's cotangent included) and accumulates in
float32; ``hist_bf16`` keeps the fused loop's history rows in bfloat16.
The same numpy-seeded inputs go through the JAX function and its port, on
the CPU.  Tolerances:

- the products, given the same float32 operands: both packages round them
  to nearest-even and sum exact float32 products, so they agree to float32
  summation order (1e-6 of the largest entry);
- losses: float32 tolerance (rtol 1e-5);
- gradients through the loss: each package computes its float32 cotangent
  in its own order before rounding it to bfloat16, so an entry whose two
  cotangents differ in the last bit can round to neighbouring bfloat16
  values: relative L2 <= 1e-4 (measured ~1e-6);
- five fused steps: f rtol 1e-5, theta relative L2 <= 1e-3, the bfloat16
  history rows and ``zg`` relative L2 <= 1e-2 (a row entry that rounds the
  other way moves by 2^-8);
- 100-iteration fits: FN-APC Spearman >= 0.98 and top-20 overlap >= 0.9
  (``tests/test_ref_parity.py:283-284``).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pydca_tpu import plm as jplm
from pydca_tpu import stats as jstats
from pydca_tpu.alphabets import RNA as JRNA
from pydca_tpu.io.fasta import MSA as JMSA
from pydca_tpu_torch import alphabets as talph
from pydca_tpu_torch import plm as tplm
from pydca_tpu_torch import score as tscore
from pydca_tpu_torch.io.fasta import MSA as TMSA
from pydca_tpu_torch.synthetic import planted_family, spearman, top_k_overlap


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


SHAPES = pytest.mark.parametrize("n,l,q", [(200, 16, 5), (120, 12, 21)], ids=["q5", "q21"])


def problem(n, l, q, seed=1):
    codes, _ = planted_family(n, l, q, seed=seed, n_pairs=3, n_ancestors=6)
    rng = np.random.default_rng(seed)
    d = l * q + l * (l - 1) // 2 * q * q
    theta = rng.normal(scale=0.1, size=d).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    return codes.astype(np.int32), theta, w, np.float32(0.2 * (l - 1))


@pytest.mark.parametrize("name", [None, "auto", "float32", "f32", "bfloat16", "bf16"])
def test_resolve_precision_matches_jax(name):
    assert tplm.resolve_precision(name) == jplm.resolve_precision(name)
    assert tplm.resolve_precision(name) == (name in ("bfloat16", "bf16"))


def test_invalid_precision_and_defaults_match_jax():
    with pytest.raises(jplm.PlmDCAException) as want:
        jplm.resolve_precision("fp16")
    with pytest.raises(tplm.PlmDCAException) as got:
        tplm.resolve_precision("fp16")
    assert str(got.value) == str(want.value)
    assert tplm.default_mm_bf16() is jplm.default_mm_bf16() is False
    # the JAX package keeps float32 rows off a TPU, and the port runs on none
    assert tplm.default_hist_bf16() is False and jplm.default_hist_bf16() is False


@SHAPES
def test_products_match_jax(n, l, q):
    """Forward ``x @ W`` and backward ``x^T @ ct`` with bfloat16 operands
    and float32 outputs, against JAX ``_logits_mm(..., True)``, its VJP and
    ``_mm_b4``: the port's ``_mm_b`` and ``_LogitsMM``'s autograd backward."""
    msa, _, _, _ = problem(n, l, q)
    rng = np.random.default_rng(0)
    x3 = np.asarray(jax.nn.one_hot(msa, q, dtype=jnp.float32))
    w4 = rng.normal(size=(l, q, q, l)).astype(np.float32)
    ct = rng.normal(size=(n, q, l)).astype(np.float32)
    want_f, vjp = jax.vjp(lambda w: jplm._logits_mm(jnp.asarray(x3), w, True), jnp.asarray(w4))
    want_b = np.asarray(vjp(jnp.asarray(ct))[0]).reshape(l * q, q * l)
    np.testing.assert_array_equal(
        want_b, np.asarray(jplm._mm_b4(jnp.asarray(x3), jnp.asarray(ct), True)).reshape(l * q, q * l))

    x = torch.tensor(x3.reshape(n, l * q))
    w = torch.tensor(w4.reshape(l * q, q * l), requires_grad=True)
    got_f = tplm._logits_mm(x, w, q, l, True)
    assert got_f.dtype == torch.float32
    assert max_rel(got_f.detach().numpy(), want_f) <= 1e-6
    got_f.backward(torch.tensor(ct))
    assert max_rel(w.grad.numpy(), want_b) <= 1e-6
    got_b = tplm._mm_b(x.to(torch.bfloat16), torch.tensor(ct), mm_bf16=True)
    assert got_b.dtype == torch.float32 and max_rel(got_b.numpy(), want_b) <= 1e-6
    acc = torch.ones(l * q, q * l)
    tplm._mm_b(x, torch.tensor(ct), acc, mm_bf16=True)
    assert max_rel(acc.numpy() - 1.0, want_b) <= 1e-6
    # rounding really happened: the float32 product is another one
    assert max_rel(np.asarray(jplm._logits_mm(jnp.asarray(x3), jnp.asarray(w4), False)),
                   want_f) > 1e-4


@SHAPES
@pytest.mark.parametrize("route", ["full", "streamed"])
def test_loss_and_grad_match_jax(n, l, q, route):
    msa, theta, w, lam = problem(n, l, q)
    pidx = jnp.asarray(jstats.pair_index_matrix(l))
    jl = jnp.float32(lam)
    if route == "full":
        fj, gj = jplm.plm_loss_and_grad(jnp.asarray(theta), jnp.asarray(msa), jnp.asarray(w),
                                        pidx, jl, jl, l, q, True)
        ft, gt = tplm.plm_loss_and_grad(torch.tensor(theta), torch.tensor(msa), torch.tensor(w),
                                        float(lam), float(lam), l, q, True)
    else:
        mb, wb = jplm._pad_to_blocks(msa, jnp.asarray(w), 32)
        fj, gj = jplm.plm_loss_and_grad_chunked(jnp.asarray(theta), mb, wb, pidx, jl, jl, l, q,
                                                True)
        ft, gt = tplm.plm_loss_and_grad_chunked(torch.tensor(theta), torch.tensor(msa),
                                                torch.tensor(w), float(lam), float(lam), l, q,
                                                32, mm_bf16=True)
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-5)
    assert rel_l2(gt.numpy(), gj) <= 1e-4
    # the bfloat16 gradient is another one than the float32 gradient
    _, g32 = tplm.plm_loss_and_grad(torch.tensor(theta), torch.tensor(msa), torch.tensor(w),
                                    float(lam), float(lam), l, q)
    assert rel_l2(gt.numpy(), g32.numpy()) > 1e-5


N, L, Q, M = 200, 16, 5, 5


def rows_of(js):
    return np.stack([np.concatenate([np.asarray(r[0], np.float32), np.asarray(r[1], np.float32)])
                     for r in js.z])


@pytest.mark.parametrize("mm_bf16,hist_bf16", [(False, True), (True, True), (True, False)],
                         ids=["hist", "products_and_hist", "products"])
def test_fused_steps_match_jax(mm_bf16, hist_bf16):
    """Five fused steps from each package's own state0, state for state."""
    codes, _ = planted_family(N, L, Q, seed=1, n_pairs=4, n_ancestors=8)
    msa = codes.astype(np.int32)
    w = np.asarray(jstats.sequence_weights(jnp.asarray(msa), 0.8, Q), np.float32)
    lam = np.float32(0.2 * (L - 1))
    jm, jw, jl = jnp.asarray(msa), jnp.asarray(w), jnp.float32(lam)
    x1h, maskq = jplm._prep_msa_jit(jm, L, Q)
    js = jplm._plm_fused_state0(jm, jw, jl, jl, L, Q, M, mm_bf16, hist_bf16)
    tm, tw = torch.tensor(msa), torch.tensor(w)
    tx, tcodes = tplm._fused_inputs(tm, L, Q, tplm._x_dtype(mm_bf16))
    ts = tplm._plm_fused_state0(tm, tw, lam, lam, L, Q, M, mm_bf16=mm_bf16, hist_bf16=hist_bf16)
    assert ts.z.dtype == (torch.bfloat16 if hist_bf16 else torch.float32)
    assert str(js.z[0][0].dtype) == ("bfloat16" if hist_bf16 else "float32")
    for k in range(1, 6):
        js = jplm._plm_fused_steps(js, x1h, maskq, jw, jl, jl, L, Q, 1, mm_bf16)
        tplm._plm_fused_steps(ts, tx, tcodes, tw, lam, lam, L, Q, 1, mm_bf16=mm_bf16)
        assert ts.k == int(js.k) == k and ts.n_evals == int(js.n_evals)
        np.testing.assert_allclose(float(ts.f), float(js.f), rtol=1e-5)
        theta_j = np.concatenate([np.asarray(js.x[0]), np.asarray(js.x[1])])
        assert rel_l2(ts.x.numpy(), theta_j) <= 1e-3
        assert rel_l2(ts.z.float().numpy(), rows_of(js)) <= 1e-2
        assert rel_l2(ts.zg.numpy(), np.asarray(js.zg)) <= 1e-2
    if hist_bf16:  # every stored row is a bfloat16 value
        rows = ts.z.float()
        assert torch.equal(rows, rows.to(torch.bfloat16).float()) and ts.z.dtype == torch.bfloat16


def test_one_step_from_converted_bf16_state():
    """A JAX state with bfloat16 rows converts to the port's (rows stay
    bfloat16), and one step from it agrees with JAX's step."""
    codes, _ = planted_family(N, L, Q, seed=1, n_pairs=4, n_ancestors=8)
    msa = codes.astype(np.int32)
    w = np.asarray(jstats.sequence_weights(jnp.asarray(msa), 0.8, Q), np.float32)
    lam = np.float32(0.2 * (L - 1))
    jm, jw, jl = jnp.asarray(msa), jnp.asarray(w), jnp.float32(lam)
    x1h, maskq = jplm._prep_msa_jit(jm, L, Q)
    js = jplm._plm_fused_state0(jm, jw, jl, jl, L, Q, M, False, True)
    js = jplm._plm_fused_steps(js, x1h, maskq, jw, jl, jl, L, Q, 3)
    ts = tplm.fused_state_from_numpy(jax.device_get(js)._asdict(), "cpu")
    assert ts.z.dtype == torch.bfloat16
    np.testing.assert_array_equal(ts.z.float().numpy(), rows_of(js))
    js = jplm._plm_fused_steps(js, x1h, maskq, jw, jl, jl, L, Q, 1)
    tx, tcodes = tplm._fused_inputs(torch.tensor(msa), L, Q)
    tplm._plm_fused_steps(ts, tx, tcodes, torch.tensor(w), lam, lam, L, Q, 1)
    assert ts.k == int(js.k) == 4
    np.testing.assert_allclose(float(ts.f), float(js.f), rtol=1e-5)
    assert rel_l2(ts.x.numpy(), np.concatenate([np.asarray(js.x[0]), np.asarray(js.x[1])])) <= 1e-4
    assert rel_l2(ts.z.float().numpy(), rows_of(js)) <= 1e-2


def fn_apc_sorted(x, l, q):
    p = l * (l - 1) // 2
    blocks = torch.tensor(np.array(x, np.float32))[l * q :].reshape(p, q, q)
    return tscore.sorted_scores(tscore.apc(tscore.frobenius_norms(blocks[:, : q - 1, : q - 1]), l), l)


@pytest.mark.parametrize("route", ["fused", "streamed"])
def test_bf16_fit_meets_rank_bar(route):
    """100 iterations with bfloat16 products in both packages (the fused
    loop with bfloat16 rows too; the streamed route over blocks of 64)."""
    n, l, q = 400, 30, 5
    codes, _ = planted_family(n, l, q, seed=7, n_pairs=8, n_ancestors=16)
    msa = codes.astype(np.int32)
    w = np.asarray(jstats.sequence_weights(jnp.asarray(msa), 0.8, q), np.float32)
    lam = np.float32(0.2 * (l - 1))
    kw = dict(hist_bf16=True) if route == "fused" else dict(seq_block=64)
    rj = jplm.fit_plm(jnp.asarray(msa), jnp.asarray(w), jnp.float32(lam), jnp.float32(lam), l, q,
                      max_iterations=100, mm_bf16=True, **kw)
    rt = tplm.fit_plm(torch.tensor(msa), torch.tensor(w), float(lam), float(lam), l, q,
                      max_iterations=100, mm_bf16=True, **kw)
    np.testing.assert_allclose(rt.fx, float(rj.fx), rtol=1e-4)
    st, sj = fn_apc_sorted(rt.x, l, q), fn_apc_sorted(rj.x, l, q)
    assert spearman(st, sj, l) >= 0.98
    assert top_k_overlap(st, sj, 20) >= 0.9


def test_engine_takes_precision_like_jax():
    """``PlmDCA(precision=...)``: the ``mm_bf16`` property and the JAX
    engine's messages for a bad precision or parameter space."""
    codes, _ = planted_family(60, 10, 5, seed=2, n_pairs=2)
    tm = TMSA(data=codes, alphabet=talph.RNA)
    jm = JMSA(data=codes, alphabet=JRNA)
    for prec in (None, "float32", "bfloat16"):
        t = tplm.PlmDCA(tm, "rna", device="cpu", precision=prec)
        assert t.mm_bf16 == jplm.PlmDCA(jm, "rna", precision=prec).mm_bf16
    for bad in (dict(precision="fp16"), dict(param_space="dense")):
        with pytest.raises(jplm.PlmDCAException) as want:
            jplm.PlmDCA(jm, "rna", **bad)
        with pytest.raises(tplm.PlmDCAException) as got:
            tplm.PlmDCA(tm, "rna", device="cpu", **bad)
        assert str(got.value) == str(want.value)
