"""The four-card cell ``pf02826_100k.plm_mesh4`` on the CPU: its
configuration cut to a toy depth and width in a copy of the benchmark, run
by the harness as two gloo ranks, with ``STREAMING_LOGITS_BYTES`` lowered in
each rank (the harness's ``patch`` hook) so that the fit streams by itself
with one block a rank, as 100000 x 195 does on the cards.  Also what the
cell reports, and the program's spans on both ranks through
``scripts/torch_mesh_spans.py``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from dcabench.harness import run_cell
from dcabench.spec import load_cell

from conftest import REPO, result_line, write_toy_root
from test_bench_faults import drop_exchange

CELL = "pf02826_100k.plm_mesh4"
SEED = 2**33 + 29
TOY = {"num_seqs": 256, "seqs_len": 48}  # 20 planted pairs need L >= 40; q 21 and float32 kept


def stream():
    """The fit streams on the toy's global N, a rank's stripe in one block
    (run in each rank)."""
    import pydca_tpu_torch.plm as prog_plm

    prog_plm.STREAMING_LOGITS_BYTES = 4 * (TOY["num_seqs"] // 2) * TOY["seqs_len"] * 21


def stream_drop_exchange():
    """:func:`stream`, with the ranks' sums of the loss and gradient left out."""
    stream()
    drop_exchange()


@pytest.fixture(scope="module")
def mesh_root(tmp_path_factory):
    root = write_toy_root(tmp_path_factory.mktemp("mesh4"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = next(c for c in bench["configs"] if c["name"] == "pf02826_100k")
    path = root / conf["file"]
    path.write_text(json.dumps({**json.loads(path.read_text()), **TOY}))
    for w in bench["workloads"]:
        if w["name"] == CELL:
            w["chips"] = 2
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def _run(root, capfd, patch, trace=False):
    assert run_cell(CELL, SEED, 0.5, trace, device="cpu", root=root, patch=patch) == 0
    return result_line(capfd.readouterr().out)


def test_cell_reports_its_metrics():
    cell = load_cell(CELL)
    assert cell.chips == 4 and cell.config["num_seqs"] == 100000
    assert {m["name"] for m in cell.end_to_end} == {"plm_family_s", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "collective_share", "collectives_per_iter", "plm_mfu", "plm_fit_roofline",
        "host_syncs_per_iter", "device_idle.plm"}
    assert "identity_counts_roofline" not in {m["name"] for m in cell.per_layer}


def test_toy_cell_is_correct_under_its_limits(mesh_root, capfd):
    res = _run(mesh_root, capfd, "test_bench_mesh4:stream")
    assert res["correct"] is True and res["device"]["count"] == 2
    limits = json.loads((REPO / "dcabench" / "limits" / f"{CELL}.json").read_text())
    assert set(res["checks"]) == set(limits)
    assert {k: c["limit"] for k, c in res["checks"].items()} == limits
    assert set(res["metrics"]) == {"plm_family_s", "setup_s"}  # no card: no device peak


def test_toy_cell_traced_reads_the_streamed_route(mesh_root, capfd):
    streamed = _run(mesh_root, capfd, "test_bench_mesh4:stream", trace=True)["metrics"]
    fused = _run(mesh_root, capfd, None, trace=True)["metrics"]
    # the streamed route sums the loss and gradient in one collective an
    # evaluation; the fused route makes one a trial and one a gradient
    assert 1.0 <= streamed["collectives_per_iter"]["value"]
    assert streamed["collectives_per_iter"]["value"] < fused["collectives_per_iter"]["value"]
    assert 0 < streamed["collective_share"]["value"] < 100
    assert streamed["host_syncs_per_iter"]["value"] > 0


def test_mesh_exchange_left_out_is_not_correct(mesh_root, capfd):
    res = _run(mesh_root, capfd, "test_bench_mesh4:stream_drop_exchange")
    assert res["correct"] is False
    check = res["checks"]["objective_gap"]
    assert check["value"] > check["limit"]


def test_mesh_spans_script_on_two_ranks(mesh_root):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), str(Path(__file__).parent)]))
    out = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "torch_mesh_spans.py"), "--workload", CELL,
         "--seed", str(SEED), "--device", "cpu", "--root", str(mesh_root),
         "--patch", "test_bench_mesh4:stream"],
        capture_output=True, text=True, env=env, cwd=str(mesh_root), timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert [r["rank"] for r in lines] == [0, 1]
    assert out.stderr.count("dcabench: idle by program span") == 2
    for r in lines:
        rows, evals = r["program"], r["fit"]["n_evals"]
        assert rows["pydca/lbfgs/evaluation"]["calls"] == evals
        assert rows["pydca/plm/block"]["calls"] == evals  # one block a rank
        assert rows["pydca/mesh/grad_allreduce"]["calls"] == r["collectives"]["grad_allreduce"][0]
        assert r["nccl_kernels"]["count"] == 0  # gloo
    assert lines[0]["fit"] == lines[1]["fit"]
