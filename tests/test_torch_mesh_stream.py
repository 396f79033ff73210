"""The port's sharded streamed plmDCA route on two gloo ranks, against the
benchmark's plain float64 reference (``dcabench/reference``), and its spans.

This is the route ``plmdca compute_fn --apc --mesh auto`` takes for a deep
family: ``PlmDCA`` decides to stream on the global N, and each rank's stripe
of the rows is one block of the streamed objective under the generic L-BFGS
loop, with the loss and its gradient summed over the ranks once an
evaluation.  Here ``STREAMING_LOGITS_BYTES`` is lowered in the workers so
that a 512 x 12 family (q 21) streams by itself with one block a rank, as
100000 x 195 does on four cards.

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
LAM = 0.2 * (L - 1)
SMALL_BLOCK = 100  # three blocks of a rank's 256 rows, for the block span's count
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
    # streams on the global N (4 N L q bytes of logits over the bound), and
    # the block, at least 1024 rows, holds a rank's stripe whole
    tplm.STREAMING_LOGITS_BYTES = 4 * (N // 2) * L * Q
    out = {}

    def run(tag, **kw):
        eng, w, ranked, res, spans, coll = _job(codes, mesh, **kw)
        stripe, w_s, _ = shard_msa(mesh, codes, w)
        theta = res.x
        f, g = tplm.plm_loss_and_grad_chunked(theta, stripe, w_s, LAM, LAM, L, Q,
                                              eng.seq_block, mesh=mesh)
        out.update({
            f"{tag}_theta": theta.numpy(), f"{tag}_weights": w.numpy(),
            f"{tag}_pairs": np.array([p for p, _ in ranked]),
            f"{tag}_scores": np.array([s for _, s in ranked]),
            f"{tag}_counts": np.array([res.num_iters, res.n_evals, res.host_syncs]),
            f"{tag}_seq_block": eng.seq_block,
            f"{tag}_f": f.item(), f"{tag}_g": g.numpy(),
            f"{tag}_span_names": np.array([s[0] for s in spans]),
            f"{tag}_span_parents": np.array([s[1] for s in spans]),
            f"{tag}_coll_names": np.array(sorted(coll)),
            f"{tag}_coll": np.array([coll[k] for k in sorted(coll)]),
        })

    run("sound")
    run("blocks", seq_block=SMALL_BLOCK)
    mm = tplm._mm
    tplm._mm = lambda a, b, mm_bf16, out=None: mm(_tf32(a), _tf32(b), mm_bf16, out)
    run("tf32")
    tplm._mm = mm
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


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
    assert int(r["sound_seq_block"]) >= N // 2  # a rank's 256 rows in one block
    assert int(r["sound_counts"][0]) == ITERS
    assert int(r["blocks_seq_block"]) == SMALL_BLOCK


@pytest.mark.parametrize("name", sorted(LIMITS))
def test_sound_route_against_the_reference(ranks, reference, name):
    assert _readings(ranks[0], "sound", reference)[name] <= LIMITS[name]


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


@pytest.mark.parametrize("tag", ["sound", "blocks", "tf32"])
def test_ranks_bitwise_equal(ranks, tag):
    a, b = ranks
    for key in ("theta", "weights", "pairs", "scores", "counts", "f", "g"):
        np.testing.assert_array_equal(a[f"{tag}_{key}"], b[f"{tag}_{key}"])


# ------------------------------------------------------------- the spans
def _spans(r, tag):
    return list(zip(r[f"{tag}_span_names"].tolist(), r[f"{tag}_span_parents"].tolist()))


@pytest.mark.parametrize("tag", ["sound", "blocks"])
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
    "plm/mm": {"plm/block"},
    "mesh/grad_allreduce": {"lbfgs/evaluation"},
}


@pytest.mark.parametrize("name", sorted(STREAM_NESTING))
def test_stream_span_nesting(ranks, name):
    parents = {p for n, p in _spans(ranks[0], "sound") if n == name}
    assert parents and parents <= STREAM_NESTING[name], (name, parents)


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
