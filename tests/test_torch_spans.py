"""The port's spans (``profiling.span``): where they open, how they nest,
how often, and that they cost nothing and change nothing.

One small fused plmDCA job (200 x 20, q 21, 4 iterations) on the CPU, as
the benchmark runs a job: a new engine, the weights, the fit, the ranked
FN-APC list.  Under ``torch.profiler`` each span is a host
``RecordFunction`` range ``pydca/<name>``; without one it is a shared null
context.
"""

import contextlib
from collections import Counter

import numpy as np
import pytest
import torch

from pydca_tpu_torch import profiling
from pydca_tpu_torch.alphabets import get_alphabet
from pydca_tpu_torch.io.fasta import MSA
from pydca_tpu_torch.ops.cuda_kernels import identity_counts
from pydca_tpu_torch.plm import PlmDCA
from pydca_tpu_torch.synthetic import planted_family

N, L, Q, ITERS = 200, 20, 21, 4
PREFIX = profiling.SPAN_PREFIX


def run_job(codes):
    eng = PlmDCA(MSA(data=codes.copy(), alphabet=get_alphabet("protein")), "protein",
                 device="cpu", max_iterations=ITERS)
    eng.compute_seqs_weight()
    params = eng.get_fields_and_couplings_from_backend()
    return eng, params, eng.compute_sorted_FN_APC()


def profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith(PREFIX)]


def span_parent(e):
    """The name of the nearest enclosing ``pydca/`` span, else ``None``."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith(PREFIX):
        p = p.cpu_parent
    return None if p is None else p.name[len(PREFIX):]


@pytest.fixture(scope="module")
def codes():
    return planted_family(N, L, Q, seed=7, n_pairs=6, n_ancestors=16)[0]


@pytest.fixture(scope="module")
def traced(codes):
    (eng, params, ranked), spans = profiled(lambda: run_job(codes))
    res = eng.fit_result
    assert res.num_iters == ITERS and not res.linesearch_failed
    return res, params, ranked, spans


NESTING = {  # span -> the spans it may open directly under
    "weights": {None},
    "identity_counts": {"weights"},
    "fit": {None},
    "plm/init": {"fit"},
    "plm/iteration": {"fit"},
    "plm/direction": {"plm/iteration"},
    "plm/linesearch": {"plm/iteration"},
    # a trial of the search, or the next step's first trial, queued behind
    # the gradient before the read that ends a step
    "plm/trial": {"plm/linesearch", "plm/iteration"},
    "plm/update": {"plm/iteration"},
    "plm/gradient": {"plm/init", "plm/iteration"},
    "plm/history": {"plm/iteration"},
    "plm/mm": {"plm/gradient", "plm/iteration"},
    "plm_trial": {"plm/trial"},
    "plm_update_grad": {"plm/gradient"},
    "lbfgs/read": {"plm/init", "plm/direction", "plm/trial", "plm/history"},
    "score": {None},
    "score/sort": {"score"},
}


@pytest.mark.parametrize("name", sorted(NESTING))
def test_span_opens_under_its_layer(traced, name):
    spans = traced[3]
    parents = {span_parent(e) for e in spans if e.name == PREFIX + name}
    assert parents, f"no span {name}"
    assert parents <= NESTING[name], (name, parents)


def test_every_span_is_named_in_the_nesting(traced):
    assert {e.name[len(PREFIX):] for e in traced[3]} == set(NESTING)


# each count read off the code of the fused loop (every step of this fit
# takes a step): one iteration span a step; every read in ``lbfgs/read``;
# n_evals counts the start's evaluation and every trial, and a trial queued
# ahead and thrown away is a trial span that n_evals leaves out; the
# products are the start's backward one, then a forward (the direction's
# image) and a backward (the gradient) a step; the passes over the logits
# are one a trial and one a gradient
COUNTS = {
    "plm/iteration": lambda r: r.num_iters,
    "plm/linesearch": lambda r: r.num_iters,
    "plm/update": lambda r: r.num_iters,
    "plm/history": lambda r: r.num_iters,
    "lbfgs/read": lambda r: r.host_syncs,
    "plm/trial": lambda r: r.n_evals - 1 + r.discarded_trials,
    "plm/gradient": lambda r: 1 + r.num_iters,
    "plm/mm": lambda r: 1 + 2 * r.num_iters,
    "plm_trial": lambda r: r.n_evals - 1 + r.discarded_trials,
    "plm_update_grad": lambda r: 1 + r.num_iters,
    "plm/init": lambda r: 1,
    "identity_counts": lambda r: 1,
}


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_span_count_matches_the_counters(traced, name):
    res, spans = traced[0], traced[3]
    calls = Counter(e.name[len(PREFIX):] for e in spans)
    assert calls[name] == COUNTS[name](res), (name, calls[name], res)


def test_no_record_function_without_a_profiler(codes, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("RecordFunction entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_range", refuse)
    eng, _, ranked = run_job(codes)
    assert eng.fit_result.num_iters == ITERS and ranked
    assert profiling.span("plm/trial") is profiling.span("fit")


def test_profiled_job_is_bitwise_the_plain_one(codes, traced):
    res, params, ranked, _ = traced
    eng, params0, ranked0 = run_job(codes)
    res0 = eng.fit_result
    np.testing.assert_array_equal(params, params0)
    assert (res.num_iters, res.n_evals, res.host_syncs) == (
        res0.num_iters, res0.n_evals, res0.host_syncs)
    assert ranked == ranked0


def test_stage_timers_open_spans():
    timers = profiling.StageTimers()
    _, spans = profiled(lambda: _stages(timers, ("gram", "inverse", "gram")))
    assert [e.name for e in spans] == ["pydca/gram", "pydca/inverse", "pydca/gram"]
    assert timers.elapsed("gram") > 0 and timers.elapsed("inverse") > 0


def _stages(timers, names):
    for name in names:
        with timers.stage(name):
            torch.ones(4).sum()


def test_identity_counts_span_on_the_cpu(codes):
    c = torch.from_numpy(codes.astype(np.int64))
    counts, spans = profiled(lambda: identity_counts(c, 0.8 * L, Q))
    assert [e.name for e in spans] == ["pydca/identity_counts"]
    assert counts.shape == (N,) and int(counts.min()) >= 1


def test_span_is_a_record_function_only_under_a_profiler():
    assert isinstance(profiling.span("x"), contextlib.nullcontext)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(profiling.span("x"), torch._C._profiler._RecordFunctionFast)


def test_spans_stay_off_the_device_timeline():
    # a user-scope range is also copied onto the card's timeline, where the
    # benchmark's trace would read it as device work; a span is not one
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("fit"):
            torch.ones(4).sum()
    (e,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "pydca/fit"]
    assert not e.is_user_annotation()
