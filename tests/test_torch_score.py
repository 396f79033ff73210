"""Port's FN scoring vs the JAX package and vs the reference engine goldens.

The goldens hold the reference Python engine's FN / FN-APC scores on the
committed fitted parameters; L and q follow from the parameters' length,
so no MSA is needed (mirrors ``tests/test_plm_engine_parity.py::_check``).
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pydca_tpu import score as jscore
from pydca_tpu_torch import score as tscore
from pydca_tpu_torch.synthetic import spearman

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def random_blocks(p, qm1, seed):
    return np.random.default_rng(seed).normal(size=(p, qm1, qm1)).astype(np.float32)


def test_gauge_shift_matches_jax():
    b = random_blocks(45, 4, 0)
    got = tscore.gauge_shift(torch.tensor(b)).numpy()
    want = np.asarray(jscore.gauge_shift(jnp.asarray(b)))
    # float32 means over <= 20 elements: reassociation differs at ~1e-7
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("qm1", [4, 20])
def test_frobenius_norms_match_jax(qm1):
    b = random_blocks(66, qm1, qm1)
    got = tscore.frobenius_norms(torch.tensor(b)).numpy()
    want = np.asarray(jscore.frobenius_norms(jnp.asarray(b)))
    # float32 sums of <= 400 squares in another order
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_apc_matches_jax():
    l = 30
    s = np.random.default_rng(3).random(l * (l - 1) // 2).astype(np.float32)
    got = tscore.apc(torch.tensor(s), l).numpy()
    want = np.asarray(jscore.apc(jnp.asarray(s), l))
    # float32 site sums of 29 terms in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sorted_scores_match_jax():
    l = 12
    s = np.random.default_rng(4).random(l * (l - 1) // 2).astype(np.float32)
    s[5] = s[9]  # a tie: both sort stably
    assert tscore.sorted_scores(torch.tensor(s), l) == jscore.sorted_scores(s, l)


def golden_case(name, q):
    params = np.load(os.path.join(GOLDENS, f"ref_plm_{name}_it100.npz"))["params"]
    d = params.size
    l = next(l for l in range(2, 4000) if l * q + l * (l - 1) // 2 * q * q == d)
    p = l * (l - 1) // 2
    blocks = params.astype(np.float32)[l * q :].reshape(p, q, q)[:, : q - 1, : q - 1]
    return l, torch.tensor(np.ascontiguousarray(blocks))


@pytest.mark.parametrize("name,q", [("rf00167", 5), ("pf02826", 21)])
@pytest.mark.parametrize("kind", ["fn", "fn_apc"])
def test_scores_match_reference_goldens(name, q, kind):
    golden = np.load(os.path.join(GOLDENS, "ref_plm_engine.npz"))
    l, blocks = golden_case(name, q)
    fn = tscore.frobenius_norms(blocks)
    ours_sorted = tscore.sorted_scores(
        tscore.apc(fn, l) if kind == "fn_apc" else fn, l
    )
    pairs = golden[f"{name}_{kind}_pairs"]
    ref_sorted = [
        ((int(i), int(j)), float(s))
        for (i, j), s in zip(pairs, golden[f"{name}_{kind}_scores"])
    ]
    ours = dict(ours_sorted)
    ref = dict(ref_sorted)
    assert ours.keys() == ref.keys()
    keys = sorted(ref)
    # float32 scoring of float32 params vs the reference's float64 numpy:
    # the same bar as the JAX engine's FN check (test_plm_engine_parity.py)
    np.testing.assert_allclose(
        [ours[k] for k in keys], [ref[k] for k in keys], rtol=1e-5, atol=1e-6
    )
    assert spearman(ours_sorted, ref_sorted, l) >= 0.9999
