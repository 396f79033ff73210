"""The port's two sharded plmDCA routes on two gloo ranks, against the
benchmark's plain float64 reference (``dcabench/reference``), and their
spans.

``plmdca compute_fn --apc --mesh auto`` decides on the rows a rank holds
whether its fit streams (``plm.fit_seq_block``).  A family deeper than K x
65,552 rows on K ranks streams: each rank's stripe is one block (or more)
of the streamed objective under the generic L-BFGS loop, with the loss and
its gradient summed over the ranks once an evaluation.  A family whose
global N passes the bound while a stripe does not, as 100000 x 195 on four
cards, takes the fused loop on each stripe, with each trial's two sums and
each gradient summed over the ranks.  Here ``STREAMING_LOGITS_BYTES`` is
lowered in the workers: to one row's logits under a stripe, so that a
512 x 12 family (q 21) streams by itself with one block a rank, and to a
stripe's logits, so that the global N streams and the stripe does not.

The module spawns itself as the worker (``python test_torch_mesh_stream.py
worker <rank> <world> <store> <indir> <outdir>``), as
``test_torch_parallel_fit.py`` does: each rank runs the engine as the CLI
does, under the CPU profiler, then once more with both logits products
taking TF32-rounded operands (the precision below float32), and saves what
it computed.  The reference side runs here, in the pytest process.
"""

import os
import sys
from collections import Counter

import numpy as np
import torch

# ---------------------------------------------------------------- the worker
# (above the test imports: a worker process imports torch and the port only)
TIMEOUT_S = 120  # each spawn's communicate(); the group's collectives time out at 60 s
N, L, Q, ITERS = 512, 12, 21, 5
STRIPE_BYTES = 4 * (N // 2) * L * Q  # a rank's logits, float32
LAM = 0.2 * (L - 1)
SMALL_BLOCK = 100  # three blocks of a rank's 256 rows, for the block span's count
# the fused fit on the stripes with this gradient test stops before its cap
# (at k = 15 on one process), so it throws away the trial it queued ahead
EPS_STOP, CAP = 0.01, 40
CKPT_KEYS = {"x": "float32", "f": "float32", "g": "float32", "s_hist": "float32",
             "y_hist": "float32", "rho": "float32", "k": "int32", "done": "bool",
             "converged": "bool", "ls_failed": "bool", "n_evals": "int32"}
PREFIX = "pydca/"


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10-bit mantissa (``dcabench.reference.tf32``)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _span_parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith(PREFIX):
        p = p.cpu_parent
    return "" if p is None else p.name[len(PREFIX):]


def _job(codes, mesh, **kw):
    """One job as the CLI runs it, under the CPU profiler: the engine's
    outputs, its fit counters, the spans (name, parent) it opened and the
    collectives it made."""
    from pydca_tpu_torch import plm as tplm
    from pydca_tpu_torch.alphabets import get_alphabet
    from pydca_tpu_torch.io.fasta import MSA

    mesh.collectives.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng = tplm.PlmDCA(MSA(data=codes.copy(), alphabet=get_alphabet("protein")), "protein",
                          device="cpu", mesh=mesh, max_iterations=ITERS, **kw)
        w = eng.compute_seqs_weight()
        eng.get_fields_and_couplings_from_backend()
        ranked = eng.compute_sorted_FN_APC()
    spans = [(e.name[len(PREFIX):], _span_parent(e)) for e in prof.events()
             if e.name.startswith(PREFIX)]
    coll = {k: list(v) for k, v in mesh.collectives.items()}
    return eng, w, ranked, eng.fit_result, spans, coll


def _worker(rank: int, world: int, store: str, indir: str, outdir: str) -> None:
    from datetime import timedelta

    import torch.distributed as dist

    from pydca_tpu_torch import plm as tplm
    from pydca_tpu_torch.parallel import init_distributed, make_mesh, shard_msa

    torch.set_num_threads(1)
    init_distributed("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                     timeout=timedelta(seconds=60))
    mesh = make_mesh(device="cpu")
    codes = np.load(os.path.join(indir, "inputs.npz"))["codes"]
    out = {}

    def run(tag, bound, **kw):
        # the rows a rank holds stream past ``bound`` bytes of logits; the
        # block, at least 1024 rows, holds a rank's stripe whole
        tplm.STREAMING_LOGITS_BYTES = bound
        eng, w, ranked, res, spans, coll = _job(codes, mesh, **kw)
        stripe, w_s, _ = shard_msa(mesh, codes, w)
        theta = res.x
        f, g = tplm.plm_loss_and_grad_chunked(theta, stripe, w_s, LAM, LAM, L, Q,
                                              eng.fit_block or N // 2, mesh=mesh)
        out.update({
            f"{tag}_theta": theta.numpy(), f"{tag}_weights": w.numpy(),
            f"{tag}_pairs": np.array([p for p, _ in ranked]),
            f"{tag}_scores": np.array([s for _, s in ranked]),
            f"{tag}_counts": np.array([res.num_iters, res.n_evals, res.host_syncs]),
            f"{tag}_seq_block": eng.seq_block,
            f"{tag}_fit_block": -1 if eng.fit_block is None else eng.fit_block,
            f"{tag}_f": f.item(), f"{tag}_g": g.numpy(),
            f"{tag}_span_names": np.array([s[0] for s in spans]),
            f"{tag}_span_parents": np.array([s[1] for s in spans]),
            f"{tag}_coll_names": np.array(sorted(coll)),
            f"{tag}_coll": np.array([coll[k] for k in sorted(coll)]),
        })

    streams = STRIPE_BYTES - 4 * L * Q  # one row's logits under a stripe
    run("sound", streams)
    run("blocks", streams, seq_block=SMALL_BLOCK)
    run("fused", STRIPE_BYTES)
    mm = tplm._mm
    tplm._mm = lambda a, b, mm_bf16, out=None: mm(_tf32(a), _tf32(b), mm_bf16, out)
    run("tf32", streams)
    run("fused_tf32", STRIPE_BYTES)
    tplm._mm = mm
    out.update(_fused_stops_and_resumes(codes, mesh, outdir))
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def _fused_stops_and_resumes(codes, mesh, outdir):
    """The fused loop on the stripes (a) stopped by the gradient test,
    which every rank reaches at the same step, throwing away the trial
    each queued (and summed) ahead; (b) saved after 6 of 12 iterations and
    resumed from the file, and (c) run unbroken."""
    from pydca_tpu_torch import plm as tplm
    from pydca_tpu_torch import stats as tstats
    from pydca_tpu_torch.parallel import shard_msa

    full = torch.from_numpy(codes.astype(np.int64))
    stripe, w_s, _ = shard_msa(mesh, full, tstats.sequence_weights(full, 0.8, Q))
    st = tplm._plm_fused_state0(stripe, w_s, LAM, LAM, L, Q, 5, epsilon=EPS_STOP, mesh=mesh)
    x1h, codes8 = tplm._fused_inputs(stripe, L, Q)
    mesh.collectives.clear()
    tplm._plm_fused_steps(st, x1h, codes8, w_s, LAM, LAM, L, Q, CAP, epsilon=EPS_STOP, mesh=mesh)
    out = {"stop_theta": st.x.numpy(),
           "stop_counts": np.array([st.k, st.n_evals, st.host_syncs, st.discarded_trials,
                                    int(st.converged), mesh.collectives["nll_allreduce"][0]])}
    ckpt = os.path.join(outdir, "fused.npz")
    fit = dict(max_iterations=12, chunk_size=3, mesh=mesh)
    tplm.fit_plm(stripe, w_s, LAM, LAM, L, Q, checkpoint_path=ckpt, checkpoint_every=3,
                 **dict(fit, max_iterations=6))
    with np.load(ckpt) as f:
        out["ckpt_keys"] = np.array(f.files)
        out["ckpt_dtypes"] = np.array([f[k].dtype.name for k in f.files])
    for tag, kw in (("resumed", dict(checkpoint_path=ckpt, checkpoint_every=3)), ("whole", {})):
        res = tplm.fit_plm(stripe, w_s, LAM, LAM, L, Q, **fit, **kw)
        out[f"{tag}_theta"] = res.x.numpy()
        out[f"{tag}_counts"] = np.array([res.num_iters, res.n_evals, res.discarded_trials])
    return out


if __name__ == "__main__":
    _worker(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    sys.exit(0)

# ---------------------------------------------------------------- the tests
import subprocess  # noqa: E402

import pytest  # noqa: E402

from dcabench.reference import judge  # noqa: E402
from dcabench.reference import plm as ref_plm  # noqa: E402
from dcabench.reference.weights import sequence_weights as ref_weights  # noqa: E402
from pydca_tpu_torch.synthetic import planted_family  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Tolerances of the float32 route against float64, each with its reason and
# the readings it lies between (this family: the sound route's, then the
# route's with TF32 products).  The objective at the port's parameters: the
# port sums 256 rows x 12 sites a rank in float32, and the two ranks' sums,
# so it stands within a few float32 ulps of the float64 value (2.8e-8);
# with TF32 products every logit carries the couplings' 2^-11 rounding
# (6.3e-6).
LOSS_RTOL = 5e-7
# The gradient, over its norm: float32 products over 256-row stripes
# (5.0e-7); TF32 rounds the coupling operand and the cotangent (1.1e-3).
GRAD_RTOL = 2e-5
# The float64 objective at the port's parameters against the reference's
# after as many iterations (the benchmark's ``objective_gap``, here its
# size): five float32 steps follow the float64 path to round-off (5.6e-8);
# a TF32 fit parts from it (1.4e-5).
OBJECTIVE_GAP = 1e-6
# The port's FN-APC scores against the float64 FN-APC of its own
# parameters, over the largest score: float32 gauge sums of 20 x 20 blocks
# (1.3e-7; the TF32 fit's 2.0e-7, since the score stage takes no product).
FNAPC_GAP = 1e-5


def spawn(tmp, world: int):
    store, outdir = os.path.join(tmp, "store"), os.path.join(tmp, "out")
    os.makedirs(outdir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(r), str(world), store, tmp,
         outdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=tmp,
    ) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"
    return [dict(np.load(os.path.join(outdir, f"rank{r}.npz"))) for r in range(world)]


@pytest.fixture(scope="module")
def codes():
    return planted_family(N, L, Q, seed=19, n_pairs=3, n_ancestors=16)[0]


@pytest.fixture(scope="module")
def ranks(codes, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_stream"))
    np.savez(os.path.join(tmp, "inputs.npz"), codes=codes)
    return spawn(tmp, 2)


@pytest.fixture(scope="module")
def reference(codes):
    t = torch.from_numpy(codes.astype(np.int64))
    return t, ref_weights(t, 0.8, Q)


def _ranked(r, tag):
    return [((int(i), int(j)), float(s)) for (i, j), s in zip(r[f"{tag}_pairs"],
                                                               r[f"{tag}_scores"])]


def _readings(r, tag, reference):
    """Each tolerance's reading of one run."""
    t, w = reference
    theta = torch.from_numpy(r[f"{tag}_theta"]).double()
    f, g = ref_plm.objective(theta, t, w, LAM, LAM, L, Q)
    jd = judge.PlmJudge(L, Q, 0.8, LAM, LAM, "cpu", max_iterations=ITERS)
    nums = jd.numbers(0, t.numpy(), r[f"{tag}_weights"], r[f"{tag}_theta"],
                      int(r[f"{tag}_counts"][0]), _ranked(r, tag))
    return {
        "loss": abs(r[f"{tag}_f"] - f) / abs(f),
        "grad": float((torch.from_numpy(r[f"{tag}_g"]).double() - g).norm() / g.norm()),
        "objective_gap": abs(nums["objective_gap"]),
        "fnapc_gap": nums["fnapc_gap"],
        "weights": nums["weights_max_abs"],
        "list_errors": nums["list_errors"],
    }


LIMITS = {"loss": LOSS_RTOL, "grad": GRAD_RTOL, "objective_gap": OBJECTIVE_GAP,
          "fnapc_gap": FNAPC_GAP, "weights": 0.0, "list_errors": 0.0}


def test_engine_streams_with_one_block_a_rank(ranks):
    r = ranks[0]
    assert int(r["sound_fit_block"]) >= N // 2  # a rank's 256 rows in one block
    assert int(r["sound_seq_block"]) == int(r["sound_fit_block"])
    assert int(r["sound_counts"][0]) == ITERS
    assert int(r["blocks_seq_block"]) == int(r["blocks_fit_block"]) == SMALL_BLOCK


def test_engine_fuses_a_stripe_under_the_bound(ranks):
    """The global N streams (the whole-alignment statistics' block), each
    rank's stripe does not: the fit takes the fused loop."""
    for r in ranks:
        assert int(r["fused_fit_block"]) == -1
        assert int(r["fused_seq_block"]) >= N // 2
        assert int(r["fused_counts"][0]) == ITERS


@pytest.mark.parametrize("name", sorted(LIMITS))
def test_sound_route_against_the_reference(ranks, reference, name):
    assert _readings(ranks[0], "sound", reference)[name] <= LIMITS[name]


@pytest.mark.parametrize("name", sorted(LIMITS))
def test_fused_route_against_the_reference(ranks, reference, name):
    assert _readings(ranks[0], "fused", reference)[name] <= LIMITS[name]


def test_weights_equal_the_reference_exactly(ranks, reference):
    np.testing.assert_array_equal(ranks[0]["sound_weights"],
                                  reference[1].numpy().astype(np.float32))


def test_fnapc_list_is_the_reference_order(ranks):
    r = ranks[0]
    ref = ref_plm.fn_apc(torch.from_numpy(r["sound_theta"]).double(), L, Q).numpy()
    iu, ju = np.triu_indices(L, k=1)
    order = np.argsort(-ref, kind="stable")
    assert [tuple(p) for p in r["sound_pairs"]] == [(iu[k], ju[k]) for k in order]


def test_tf32_products_fail_a_tolerance(ranks, reference):
    got = _readings(ranks[0], "tf32", reference)
    assert any(got[k] > LIMITS[k] for k in LIMITS), got


def test_fused_tf32_products_fail_a_tolerance(ranks, reference):
    got = _readings(ranks[0], "fused_tf32", reference)
    assert any(got[k] > LIMITS[k] for k in LIMITS), got


@pytest.mark.parametrize("tag", ["sound", "blocks", "tf32", "fused", "fused_tf32"])
def test_ranks_bitwise_equal(ranks, tag):
    a, b = ranks
    for key in ("theta", "weights", "pairs", "scores", "counts", "f", "g"):
        np.testing.assert_array_equal(a[f"{tag}_{key}"], b[f"{tag}_{key}"])


# ------------------------------------------------------------- the spans
def _spans(r, tag):
    return list(zip(r[f"{tag}_span_names"].tolist(), r[f"{tag}_span_parents"].tolist()))


@pytest.mark.parametrize("tag", ["sound", "blocks", "fused"])
def test_one_mesh_span_a_collective(ranks, tag):
    for r in ranks:
        calls = Counter(n for n, _ in _spans(r, tag) if n.startswith("mesh/"))
        coll = dict(zip(r[f"{tag}_coll_names"].tolist(), r[f"{tag}_coll"]))
        assert calls == {f"mesh/{k}": int(v[0]) for k, v in coll.items()}
        assert {"mesh/grad_allreduce", "mesh/weights_allreduce"} <= set(calls)


def test_collectives_count_their_bytes(ranks):
    coll = dict(zip(ranks[0]["sound_coll_names"].tolist(), ranks[0]["sound_coll"]))
    # [calls, elements, seconds, bytes]: float32 sums and int32 counts, 4 bytes each
    for name, (_, numel, _, nbytes) in coll.items():
        assert nbytes == 4 * numel, name
    d = L * Q + L * (L - 1) // 2 * Q * Q
    calls, numel = coll["grad_allreduce"][:2]
    assert numel == calls * (d + 1)  # the gradient and the loss in one buffer


def test_chip_smoke_reads_the_collectives(ranks):
    """``chip_smoke.py``'s two lines of the collectives read the records a
    run leaves (``[calls, elements, seconds, bytes]``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    names = ranks[0]["sound_coll_names"].tolist()
    coll = {k: [int(v[0]), int(v[1]), float(v[2]), int(v[3])]
            for k, v in zip(names, ranks[0]["sound_coll"])}
    text = smoke.collective_text(coll, 1, "run")
    listed = smoke.collective_list(coll)
    for k, (calls, _, _, _) in coll.items():
        assert f"{k} {calls:.2f}x" in text
        assert f"{k} {calls}x" in listed


@pytest.mark.parametrize("tag, blocks", [("sound", 1), ("blocks", 3)])
def test_evaluation_and_block_spans_count(ranks, tag, blocks):
    r = ranks[0]
    iters, evals, _ = (int(v) for v in r[f"{tag}_counts"])
    calls = Counter(n for n, _ in _spans(r, tag))
    assert calls["lbfgs/evaluation"] == evals
    assert calls["plm/block"] == blocks * evals
    assert calls["mesh/grad_allreduce"] == evals  # one collective an evaluation
    assert calls["lbfgs/direction"] == calls["lbfgs/linesearch"] == iters


STREAM_NESTING = {  # the generic loop's spans -> the spans they open directly under
    "lbfgs/direction": {"fit"},
    "lbfgs/linesearch": {"fit"},
    "lbfgs/evaluation": {"fit", "lbfgs/linesearch"},
    "plm/block": {"lbfgs/evaluation"},
    "plm/onehot": {"plm/block"},
    "plm/mm": {"plm/block"},
    "plm/pullback": {"lbfgs/evaluation"},
    "mesh/grad_allreduce": {"plm/pullback"},
}


@pytest.mark.parametrize("name", sorted(STREAM_NESTING))
def test_stream_span_nesting(ranks, name):
    parents = {p for n, p in _spans(ranks[0], "sound") if n == name}
    assert parents and parents <= STREAM_NESTING[name], (name, parents)


def test_fused_route_on_the_stripes(ranks):
    """Each rank runs the fused loop: ``plm/iteration`` and no streamed
    block; one sum of the loss a line-search trial (and the first), one of
    the gradient a step (and the first)."""
    for r in ranks:
        iters, evals, _ = (int(v) for v in r["fused_counts"])
        calls = Counter(n for n, _ in _spans(r, "fused"))
        assert calls["plm/iteration"] >= iters and calls["plm/init"] == 1
        assert not {n for n in calls if n.startswith(("plm/block", "lbfgs/evaluation",
                                                      "lbfgs/direction", "lbfgs/linesearch"))}
        assert calls["mesh/nll_allreduce"] == evals
        assert calls["mesh/grad_allreduce"] == iters + 1


def test_stream_route_opens_none_of_the_fused_spans(ranks):
    names = {n for n, _ in _spans(ranks[0], "sound")}
    assert not names & {"plm/init", "plm/iteration", "plm/trial", "plm/gradient",
                        "plm_trial", "plm_update_grad"}


def test_fused_route_opens_none_of_the_stream_spans(codes):
    from pydca_tpu_torch.alphabets import get_alphabet
    from pydca_tpu_torch.io.fasta import MSA
    from pydca_tpu_torch.plm import PlmDCA

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng = PlmDCA(MSA(data=codes.copy(), alphabet=get_alphabet("protein")), "protein",
                     device="cpu", max_iterations=2)
        eng.compute_sorted_FN_APC()
    names = {e.name[len(PREFIX):] for e in prof.events() if e.name.startswith(PREFIX)}
    assert eng.seq_block is None and "plm/iteration" in names
    assert not {n for n in names if n.startswith(("lbfgs/evaluation", "lbfgs/direction",
                                                  "lbfgs/linesearch", "plm/block", "mesh/"))}


# ------------------------------------------------- the benchmark's reader
def test_collectives_per_iter_reader():
    from types import SimpleNamespace

    from dcabench.spec import reader

    read = reader("collectives_per_iter")
    job = lambda iters, coll: SimpleNamespace(fit={"num_iters": iters},  # noqa: E731
                                              collectives=coll)
    jobs = [job(100, {"grad_allreduce": [106, 106 * 8, 0.0, 106 * 32]}),
            job(50, {"grad_allreduce": [53, 53 * 8, 0.0, 53 * 32],
                     "weights_allreduce": [1, 8, 0.0, 32]})]
    assert read(SimpleNamespace(kind="plm", jobs=jobs)) == pytest.approx(160 / 150)
    # one card: no collectives, nothing to read; mean-field: not a plm cell
    assert read(SimpleNamespace(kind="plm", jobs=[job(100, {})])) is None
    assert read(SimpleNamespace(kind="mf", jobs=jobs)) is None


# ------------------------------------------ the fused loop's queued trials
def test_fused_fit_stops_on_the_gradient_test_on_every_rank(ranks, codes):
    """Both ranks stop at the same step, each having summed and thrown
    away the trial it queued ahead (no rank waits on the other's
    collective), and the fit is the one-process fit's."""
    from pydca_tpu_torch import plm as tplm
    from pydca_tpu_torch import stats as tstats

    a, b = ranks
    np.testing.assert_array_equal(a["stop_counts"], b["stop_counts"])
    np.testing.assert_array_equal(a["stop_theta"], b["stop_theta"])
    k, evals, syncs, discarded, converged, nll_sums = (int(v) for v in a["stop_counts"])
    assert converged and k < CAP and discarded == 1
    assert syncs == evals + 2 and nll_sums == evals - 1 + discarded
    full = torch.from_numpy(codes.astype(np.int64))
    w = tstats.sequence_weights(full, 0.8, Q)
    one = tplm._plm_fused_state0(full, w, LAM, LAM, L, Q, 5, epsilon=EPS_STOP)
    x1h, codes8 = tplm._fused_inputs(full, L, Q)
    tplm._plm_fused_steps(one, x1h, codes8, w, LAM, LAM, L, Q, CAP, epsilon=EPS_STOP)
    assert (one.k, one.n_evals, one.discarded_trials) == (k, evals, discarded)
    theta = one.x.numpy()
    assert np.linalg.norm(a["stop_theta"] - theta) <= 1e-5 * np.linalg.norm(theta)


def test_fused_checkpoint_resumes_to_the_unbroken_fit(ranks):
    """A mesh fit saved after 6 of 12 iterations (the generic format, keys
    and dtypes as ever) and resumed from the file reaches the unbroken
    fit: the same counts, the iterate to float recompute."""
    for r in ranks:
        assert dict(zip(r["ckpt_keys"].tolist(), r["ckpt_dtypes"].tolist())) == CKPT_KEYS
        assert r["ckpt_keys"].tolist() == list(CKPT_KEYS)
        np.testing.assert_array_equal(r["resumed_counts"], r["whole_counts"])
        assert int(r["whole_counts"][0]) == 12
        whole = r["whole_theta"]
        assert np.linalg.norm(r["resumed_theta"] - whole) <= 1e-5 * np.linalg.norm(whole)
