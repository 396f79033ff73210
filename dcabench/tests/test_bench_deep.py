"""The one-card cell ``pf02826_100k_1card.plm_deep`` on the CPU: its
configuration cut to a toy depth and width in a copy of the benchmark, run
by the harness with its traffic mix and limits, and with
``STREAMING_LOGITS_BYTES`` lowered (the harness's ``patch`` hook) so that
the fit streams by itself over two blocks, the last one short, under the
generic L-BFGS loop, as 100000 x 195 does on one card over blocks of 65,552
and 34,448 rows.  Also what the cell reports, its spans through
``dcabench.program_spans``, and the reader ``evals_per_iter``."""

import json
from types import SimpleNamespace

import pytest

import pydca_tpu_torch.plm as prog_plm
from dcabench import program_spans
from dcabench.calibrate import cut_fit
from dcabench.harness import _pool_path, pool_size, run_cell
from dcabench.spec import load_cell, reader

from conftest import REPO, result_line, write_toy_root

CELL = "pf02826_100k_1card.plm_deep"
SEED = 2**33 + 41
# 20 planted pairs need L >= 40; q 21 and float32 kept; past one block of 1024 rows
TOY = {"num_seqs": 1100, "seqs_len": 48}


def stream():
    """The fit streams over blocks of 1024 rows (``streaming_block``'s
    least), 1024 and 76 of the toy's."""
    prog_plm.STREAMING_LOGITS_BYTES = 4 * 1024 * TOY["seqs_len"] * 21


def stream_cut10():
    """:func:`stream`, with the fit cut at 10 iterations."""
    stream()
    prog_plm.fit_plm = cut_fit(prog_plm.fit_plm)


@pytest.fixture(autouse=True)
def restore_program():
    """A one-card run applies its patch in this process: undo it."""
    bound, fit = prog_plm.STREAMING_LOGITS_BYTES, prog_plm.fit_plm
    yield
    prog_plm.STREAMING_LOGITS_BYTES, prog_plm.fit_plm = bound, fit


@pytest.fixture(scope="module")
def deep_root(tmp_path_factory):
    root = write_toy_root(tmp_path_factory.mktemp("deep"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = next(c for c in bench["configs"] if c["name"] == "pf02826_100k_1card")
    path = root / conf["file"]
    path.write_text(json.dumps({**json.loads(path.read_text()), **TOY}))
    return root


def _run(root, capfd, patch, trace=False):
    assert run_cell(CELL, SEED, 0.5, trace, device="cpu", root=root, patch=patch) == 0
    return result_line(capfd.readouterr().out)


def test_cell_reports_its_metrics():
    cell = load_cell(CELL)
    c = cell.config
    assert cell.chips == 1 and (c["num_seqs"], c["seqs_len"], c["q"]) == (100000, 195, 21)
    assert c["precision"] == "float32"
    assert {m["name"] for m in cell.end_to_end} == {"plm_family_s", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "plm_mfu", "plm_fit_roofline", "host_syncs_per_iter", "evals_per_iter",
        "device_idle.plm", "identity_counts_roofline"}
    # streamed on one card over two blocks, the last one short
    assert prog_plm.fit_seq_block(c["num_seqs"], c["seqs_len"], c["q"]) == 65552
    # two families, the four-card cell's pool file
    mesh4 = load_cell("pf02826_100k.plm_mesh4")
    assert pool_size(cell) == pool_size(mesh4) == 2
    assert _pool_path(cell, 2) == _pool_path(mesh4, 2)


def test_toy_cell_is_correct_under_its_limits(deep_root, capfd):
    res = _run(deep_root, capfd, "test_bench_deep:stream", trace=True)
    assert res["correct"] is True and res["device"]["count"] == 1
    limits = json.loads((REPO / "dcabench" / "limits" / f"{CELL}.json").read_text())
    assert {k: c["limit"] for k, c in res["checks"].items()} == limits
    assert res["metrics"]["evals_per_iter"]["unit"] == "evals/iter"
    assert 1.0 < res["metrics"]["evals_per_iter"]["value"] < 2.0
    assert res["metrics"]["host_syncs_per_iter"]["value"] > 0


def test_fit_cut_at_10_is_not_correct(deep_root, capfd):
    res = _run(deep_root, capfd, "test_bench_deep:stream_cut10")
    assert res["correct"] is False
    check = res["checks"]["stop_gap"]
    assert check["value"] > check["limit"]


def test_traced_fit_takes_the_streamed_route(deep_root, capsys):
    stream()
    assert program_spans.main(["--workload", CELL, "--seed", str(SEED), "--device", "cpu"],
                              root=deep_root) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rows, evals = line["program"], line["fit"]["n_evals"]
    assert rows["pydca/lbfgs/evaluation"]["calls"] == evals
    assert rows["pydca/plm/block"]["calls"] == rows["pydca/plm/onehot"]["calls"] == 2 * evals
    assert rows["pydca/plm/pullback"]["calls"] == evals
    assert "pydca/plm/iteration" not in rows


def test_evals_per_iter_reader():
    read = reader("evals_per_iter")
    job = lambda iters, evals: SimpleNamespace(fit={"num_iters": iters,  # noqa: E731
                                                    "n_evals": evals, "host_syncs": 0})
    jobs = [job(100, 104), job(100, 106), job(50, 55)]
    assert read(SimpleNamespace(kind="plm", jobs=jobs)) == pytest.approx(265 / 250)
    assert read(SimpleNamespace(kind="plm", jobs=[job(0, 1)])) is None
    assert read(SimpleNamespace(kind="mf", jobs=jobs)) is None
