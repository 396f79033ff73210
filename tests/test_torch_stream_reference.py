"""The port's one-device streamed plmDCA route against the benchmark's
plain float64 reference (``dcabench/reference``), and its spans.

``PlmDCA`` on one device streams by itself once the (N, q, L) float32
logits pass ``plm.STREAMING_LOGITS_BYTES``: the streamed objective over
blocks of ``plm.streaming_block`` rows (at least 1024), the last one
short, under the generic L-BFGS loop, as 100000 x 195 runs on one card
over blocks of 65,552 and 34,448 rows.  Here the bound is lowered to 1024
rows' logits, so that a 2600 x 24 family (q 21) streams over blocks of
1024, 1024 and 552 rows.  The engine runs as the CLI runs it, under the
CPU profiler, once as it is and once with both logits products taking
TF32-rounded operands (the precision below float32).  The tolerances, and
the reasons for them, are ``test_torch_mesh_stream.py``'s.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from dcabench.reference import judge
from dcabench.reference import plm as ref_plm
from dcabench.reference.weights import sequence_weights as ref_weights
from pydca_tpu_torch import plm as tplm
from pydca_tpu_torch.alphabets import get_alphabet
from pydca_tpu_torch.io.fasta import MSA
from pydca_tpu_torch.synthetic import planted_family
from test_torch_mesh_stream import LIMITS, PREFIX, _span_parent, _tf32

N, L, Q, ITERS = 2600, 24, 21, 5
LAM = 0.2 * (L - 1)
BLOCK = 1024
BLOCKS = [1024, 1024, 552]


def _job(codes, **kw):
    """One job as the CLI runs it, under the CPU profiler: the outputs, the
    fit's counters, the spans (name, parent) it opened, and the streamed
    loss and gradient at its parameters."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng = tplm.PlmDCA(MSA(data=codes.copy(), alphabet=get_alphabet("protein")), "protein",
                          device="cpu", **kw)
        w = eng.compute_seqs_weight()
        theta = eng.get_fields_and_couplings_from_backend()
        ranked = eng.compute_sorted_FN_APC()
    spans = [(e.name[len(PREFIX):], _span_parent(e)) for e in prof.events()
             if e.name.startswith(PREFIX)]
    out = {"eng": eng, "weights": w.numpy(), "theta": theta, "ranked": ranked,
           "res": eng.fit_result, "spans": spans}
    if eng.fit_block is not None:
        f, g = tplm.plm_loss_and_grad_chunked(torch.from_numpy(theta), eng._msa_tensor(), w,
                                              LAM, LAM, L, Q, eng.fit_block)
        out.update(f=f.item(), g=g.numpy())
    return out


@pytest.fixture(scope="module")
def codes():
    return planted_family(N, L, Q, seed=23, n_pairs=4, n_ancestors=16)[0]


@pytest.fixture(scope="module")
def runs(codes):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tplm, "STREAMING_LOGITS_BYTES", 4 * BLOCK * L * Q)
        out["sound"] = _job(codes, max_iterations=ITERS)
        mm = tplm._mm
        mp.setattr(tplm, "_mm",
                   lambda a, b, mm_bf16, out=None: mm(_tf32(a), _tf32(b), mm_bf16, out))
        out["tf32"] = _job(codes, max_iterations=ITERS)
    return out


@pytest.fixture(scope="module")
def reference(codes):
    t = torch.from_numpy(codes.astype(np.int64))
    return t, ref_weights(t, 0.8, Q)


def _readings(r, reference):
    """Each tolerance's reading of one run."""
    t, w = reference
    theta = torch.from_numpy(r["theta"]).double()
    f, g = ref_plm.objective(theta, t, w, LAM, LAM, L, Q)
    jd = judge.PlmJudge(L, Q, 0.8, LAM, LAM, "cpu", max_iterations=ITERS)
    nums = jd.numbers(0, t.numpy(), r["weights"], r["theta"], r["res"].num_iters, r["ranked"])
    return {
        "loss": abs(r["f"] - f) / abs(f),
        "grad": float((torch.from_numpy(r["g"]).double() - g).norm() / g.norm()),
        "objective_gap": abs(nums["objective_gap"]),
        "fnapc_gap": nums["fnapc_gap"],
        "weights": nums["weights_max_abs"],
        "list_errors": nums["list_errors"],
    }


def test_engine_streams_over_three_blocks(runs):
    eng, res = runs["sound"]["eng"], runs["sound"]["res"]
    assert eng.seq_block == eng.fit_block == BLOCK
    assert [min(BLOCK, N - s) for s in range(0, N, BLOCK)] == BLOCKS
    assert res.num_iters == ITERS and res.n_evals > ITERS


@pytest.mark.parametrize("name", sorted(LIMITS))
def test_streamed_route_against_the_reference(runs, reference, name):
    assert _readings(runs["sound"], reference)[name] <= LIMITS[name]


def test_weights_equal_the_reference_exactly(runs, reference):
    np.testing.assert_array_equal(runs["sound"]["weights"],
                                  reference[1].numpy().astype(np.float32))


def test_fnapc_list_is_the_reference_order(runs):
    r = runs["sound"]
    ref = ref_plm.fn_apc(torch.from_numpy(r["theta"]).double(), L, Q).numpy()
    iu, ju = np.triu_indices(L, k=1)
    order = np.argsort(-ref, kind="stable")
    assert [p for p, _ in r["ranked"]] == [(iu[k], ju[k]) for k in order]


def test_tf32_products_fail_a_tolerance(runs, reference):
    got = _readings(runs["tf32"], reference)
    assert any(got[k] > LIMITS[k] for k in LIMITS), got


def test_streamed_spans_count_and_nest(runs):
    r = runs["sound"]
    evals = r["res"].n_evals
    calls = Counter(n for n, _ in r["spans"])
    assert calls["lbfgs/evaluation"] == evals
    assert calls["plm/block"] == calls["plm/onehot"] == len(BLOCKS) * evals
    assert calls["plm/pullback"] == evals
    parents = {n: {p for m, p in r["spans"] if m == n} for n in ("plm/onehot", "plm/pullback")}
    assert parents == {"plm/onehot": {"plm/block"}, "plm/pullback": {"lbfgs/evaluation"}}


def test_fused_route_opens_neither_new_span(codes):
    r = _job(codes, max_iterations=2)
    names = {n for n, _ in r["spans"]}
    assert r["eng"].fit_block is None and "plm/iteration" in names
    assert not names & {"plm/onehot", "plm/pullback", "plm/block"}
