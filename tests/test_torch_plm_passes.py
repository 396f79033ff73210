"""The fused plmDCA step's passes over the logits on the CPU
(``ops.cuda_kernels.plm_trial`` / ``plm_update_grad``): given CPU tensors
they return exactly what the step's plain composition returned before the
passes became kernels (written out below as it stood in ``plm.py``), on one
rank's rows and on a two-rank ``_data_sum``.  The kernels themselves are
held to these on the card (``tests/test_torch_kernels_gpu.py``).
"""

import numpy as np
import pytest
import torch

from pydca_tpu_torch import plm
from pydca_tpu_torch.ops import cuda_kernels as ck
from pydca_tpu_torch.synthetic import planted_family

N, L = 300, 37


def old_prep_u(u_mm, maskq, d, l, q):
    """The direction's image as the step built it: u += d_h, then its picks."""
    u = u_mm.clone()
    u += d[: l * q].reshape(l, q).T[None]
    return u, torch.where(maskq, u, torch.zeros(())).sum(dim=1)


def old_phi_dphi(logits, picked, u, upicked, weights, alpha):
    t = logits + alpha * u
    mx = t.amax(dim=1)
    e = torch.exp(t - mx[:, None, :])
    se = e.sum(dim=1)
    lse = mx + torch.log(se)
    pk = picked + alpha * upicked
    nll = (weights[:, None] * (lse - pk)).sum()
    su = (e * u).sum(dim=1) / se
    dnll = (weights[:, None] * (su - upicked)).sum()
    return nll, dnll


def old_ct_gh(logits, maskq, weights):
    ct = (logits - logits.amax(dim=1, keepdim=True)).exp_()
    ct.div_(ct.sum(dim=1, keepdim=True)).sub_(maskq.to(ct.dtype))
    ct.mul_(weights[:, None, None])
    return ct, ct.sum(dim=0)


def problem(q, n=N, seed=0):
    """The fused loop's uint8 codes, their pick mask, the carried logits and
    picks, a direction (its fields d_h and couplings image u) and weights."""
    codes = torch.tensor(planted_family(n, L, q, seed=seed + q, n_pairs=3)[0])
    _, sel = plm._fused_inputs(codes, L, q)
    maskq = plm._pick_mask(codes, q)
    rng = np.random.default_rng(seed)
    logits = torch.tensor(rng.normal(scale=2.0, size=(n, q, L)), dtype=torch.float32)
    picked = plm._picked(logits, maskq)
    u = torch.tensor(rng.normal(scale=0.5, size=(n, q, L)), dtype=torch.float32)
    d = torch.tensor(rng.normal(scale=0.3, size=L * q + 5), dtype=torch.float32)
    w = torch.tensor(rng.uniform(0.05, 1.0, n), dtype=torch.float32)
    return sel, maskq, logits, picked, u, d, w


@pytest.mark.parametrize("alpha", [0.0, 0.37, 3.5])
@pytest.mark.parametrize("q", [5, 21])
def test_trial_equals_the_composition(q, alpha):
    sel, maskq, logits, picked, u, d, w = problem(q)
    got = ck.plm_trial(logits, sel, w, picked, u, d[: L * q].view(L, q), alpha)
    u_old, up_old = old_prep_u(u, maskq, d, L, q)
    want = torch.stack(old_phi_dphi(logits, picked, u_old, up_old, w, alpha))
    assert got.dtype == torch.float32 and got.shape == (2,)
    assert torch.equal(got, want)


@pytest.mark.parametrize("step", ["no_u", "alpha_0", "alpha"])
@pytest.mark.parametrize("q", [5, 21])
def test_update_grad_equals_the_composition(q, step):
    sel, maskq, logits, picked, u, d, w = problem(q)
    alpha = {"no_u": 0.0, "alpha_0": 0.0, "alpha": 0.61}[step]
    lg, pk = logits.clone(), picked.clone()
    if step == "no_u":
        ct, gh = ck.plm_update_grad(lg, sel, w)
    else:
        ct, gh = ck.plm_update_grad(lg, sel, w, pk, u, d[: L * q].view(L, q), alpha)
        u_old, up_old = old_prep_u(u, maskq, d, L, q)
        logits.add_(u_old, alpha=alpha)
        picked.add_(up_old, alpha=alpha)
    ct_old, gh_old = old_ct_gh(logits, maskq, w)
    assert torch.equal(lg, logits) and torch.equal(pk, picked)
    assert torch.equal(ct, ct_old) and torch.equal(gh, gh_old)
    assert gh.shape == (q, L) and ct.shape == (N, q, L)


class _TwoRanks:
    """A mesh of two ranks over one process: ``sum_`` adds the other
    rank's vector in place, as an all-reduce of two would."""

    def __init__(self, other):
        self.other = other

    def sum_(self, t, name, axis="data"):
        t.add_(self.other)


@pytest.mark.parametrize("q", [5, 21])
def test_trial_on_two_ranks_equals_the_composition(q):
    sel, maskq, logits, picked, u, d, w = problem(q, n=2 * 151)
    dh = d[: L * q].view(L, q)
    u_old, up_old = old_prep_u(u, maskq, d, L, q)
    rows = (slice(0, 151), slice(151, None))
    alpha = 0.29
    old = [torch.stack(old_phi_dphi(logits[r], picked[r], u_old[r], up_old[r], w[r], alpha))
           for r in rows]
    for rank, r in enumerate(rows):
        mine = ck.plm_trial(logits[r], sel[r], w[r], picked[r], u[r], dh, alpha)
        assert torch.equal(mine, old[rank])
        summed = plm._data_sum(_TwoRanks(old[1 - rank]), mine)
        assert torch.equal(summed, old[rank] + old[1 - rank])
    assert plm._data_sum(None, old[0]) is old[0]


@pytest.mark.parametrize("q", [5, 21])
def test_fused_inputs_state_the_mask(q):
    """The fused loop's codes pick what the loss's pick mask picks, and its
    one-hot is the loss's."""
    codes = torch.tensor(planted_family(50, L, q, seed=q, n_pairs=1)[0])
    x1h, maskq = plm._prep_msa(codes, L, q)
    fx, sel = plm._fused_inputs(codes, L, q)
    assert sel.dtype == torch.uint8 and sel.is_contiguous()
    assert torch.equal(sel.long(), codes.long()) and torch.equal(fx, x1h)
    assert torch.equal(plm._pick_mask(sel, q), maskq)
    # a code outside [0, q) picks no state, in the mask as in the kernels
    sel[3, 4] = q
    assert not bool(plm._pick_mask(sel, q)[3, :, 4].any())


def test_wrappers_check_their_inputs():
    sel, maskq, logits, picked, u, d, w = problem(5, n=20)
    dh = d[: L * 5].view(L, 5)
    with pytest.raises(ValueError, match="u must be"):
        ck.plm_trial(logits, sel, w, picked, u[:, :, :-1], dh, 0.1)
    with pytest.raises(TypeError, match="weights must be"):
        ck.plm_trial(logits, sel, w.double(), picked, u, dh, 0.1)
    with pytest.raises(ValueError, match="dh must be"):
        ck.plm_update_grad(logits, sel, w, picked, u, dh.T, 0.1)
    with pytest.raises(ValueError, match="needs picked and dh"):
        ck.plm_update_grad(logits, sel, w, None, u, dh, 0.1)
    with pytest.raises(TypeError, match="codes must be an integer"):
        ck.plm_update_grad(logits, sel.float(), w)


def test_cpu_passes_count_no_launch():
    sel, maskq, logits, picked, u, d, w = problem(5, n=20)
    before = (ck.plm_trial.launches, ck.plm_update_grad.launches)
    ck.plm_trial(logits, sel, w, picked, u, d[: L * 5].view(L, 5), 0.5)
    ck.plm_update_grad(logits, sel, w)
    assert (ck.plm_trial.launches, ck.plm_update_grad.launches) == before
