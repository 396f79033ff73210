"""The program's spans reduced to one row a name (``dcabench/program_spans.py``),
on synthetic records, and the four readers of that table."""

import json
from types import SimpleNamespace

import pytest
import torch

from dcabench import program_spans
from dcabench.spec import reader
from dcabench.trace import profile
from dcabench.yardstick import identity_bound
from pydca_tpu_torch.profiling import span

# the host: a fit holding an iteration, which holds a product and a read
SPANS = [
    (0.0, 10.0, "pydca/fit"),
    (1.0, 9.0, "pydca/plm/iteration"),
    (2.0, 4.0, "pydca/plm/mm"),
    (5.0, 8.0, "pydca/lbfgs/read"),
    (20.0, 22.0, "pydca/score"),
]


def test_kernel_launched_under_nested_spans_counts_toward_each():
    rows = program_spans.table(SPANS, [(2.5, 3.0, 6.0)])
    for name in ("pydca/fit", "pydca/plm/iteration", "pydca/plm/mm"):
        assert (rows[name]["kernels"], rows[name]["device_s"]) == (1, 3.0)
    for name in ("pydca/lbfgs/read", "pydca/score"):
        assert (rows[name]["kernels"], rows[name]["device_s"]) == (0, 0.0)


@pytest.mark.parametrize("launch", [12.0, -1.0, None])
def test_kernel_launched_outside_every_span_counts_toward_none(launch):
    rows = program_spans.table(SPANS, [(launch, 12.5, 13.0)])
    assert all(r["kernels"] == 0 and r["device_s"] == 0.0 for r in rows.values())
    assert rows["pydca/fit"]["calls"] == 1 and rows["pydca/fit"]["wall_s"] == 10.0


def test_idle_is_named_by_the_innermost_span():
    # the device runs [0, 3] and [6, 7]: idle in the fit [3, 6] and [7, 10]
    rows = program_spans.table(SPANS, [(0.5, 0.0, 3.0), (5.5, 6.0, 7.0)])
    self_idle = {n: r["idle_self_s"] for n, r in rows.items()}
    assert self_idle == pytest.approx({"pydca/fit": 1.0, "pydca/plm/iteration": 2.0,
                                       "pydca/plm/mm": 1.0, "pydca/lbfgs/read": 2.0,
                                       "pydca/score": 2.0})
    assert rows["pydca/fit"]["idle_s"] == pytest.approx(6.0)
    assert rows["pydca/plm/iteration"]["idle_s"] == pytest.approx(5.0)
    line = program_spans.idle_line(rows, top=2)
    assert line.startswith("dcabench: idle by program span: ")
    assert line.count(", ") == 1 and "pydca/plm/mm" not in line


def test_spans_ending_and_starting_together_nest():
    spans = [(0.0, 2.0, "pydca/a"), (0.0, 1.0, "pydca/b"), (1.0, 2.0, "pydca/c")]
    rows = program_spans.table(spans, [(1.0, 5.0, 6.0), (0.0, 7.0, 8.0)])
    assert [rows[n]["kernels"] for n in ("pydca/a", "pydca/b", "pydca/c")] == [2, 1, 1]
    assert rows["pydca/a"]["idle_self_s"] == 0.0


def test_records_of_a_cpu_profile():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("fit"):
            with span("plm/mm"):
                torch.ones(8) @ torch.ones(8)
        with torch.profiler.record_function("dcabench/job"):
            pass
    spans, ops = program_spans.records(prof)
    assert [s[2] for s in sorted(spans)] == ["pydca/fit", "pydca/plm/mm"]
    assert ops == []
    rows = program_spans.table(spans, ops)
    assert rows["pydca/fit"]["calls"] == 1 and rows["pydca/fit"]["kernels"] == 0


def job_with_spans():
    with torch.profiler.record_function("dcabench/job"):
        with span("fit"):
            return torch.ones(4).sum()


def test_profile_keeps_program_spans_out_of_its_summary():
    _, summary = profile(job_with_spans)
    assert set(summary) == {"busy_s", "window_s", "span_busy", "span_wall", "device_ops",
                            "idle_gaps"}
    assert summary["span_wall"] == {} and summary["device_ops"] == []
    _, rows = program_spans.profile(job_with_spans)
    assert set(rows) == {"pydca/fit"} and rows["pydca/fit"]["calls"] == 1


def test_main_traces_one_job_of_a_cell(toy_root, capsys):
    assert program_spans.main(["--workload", "toy.plm", "--seed", str(2**31 + 5),
                               "--device", "cpu"], root=toy_root) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["fit"]["num_iters"] > 0 and line["wall_s"] > 0 and line["untraced_wall_s"] > 0
    rows = line["program"]
    assert rows["pydca/plm/iteration"]["calls"] == line["fit"]["num_iters"]
    assert rows["pydca/lbfgs/read"]["calls"] == line["fit"]["host_syncs"]
    assert rows["pydca/fit"]["calls"] == rows["pydca/identity_counts"]["calls"] == 1
    assert line["readings"] == dict.fromkeys(program_spans.READERS)  # nothing off the card
    assert "dcabench: idle by program span: " in err


NEW = ("lbfgs_host_ms_per_iter", "fit_nonproduct_ms_per_iter", "fit_kernels_per_iter",
       "identity_counts_kernel_roofline")


def _run(program):
    profile_ = None if program is None else {"busy_s": 1.0, "program": program}
    return SimpleNamespace(kind="plm", n=16384, l=195, q=21, profile=profile_,
                           profiled=SimpleNamespace(fit={"num_iters": 80}))


def _row(kernels, device_s, idle_s=0.0, calls=1):
    return {"calls": calls, "wall_s": 1.0, "device_s": device_s, "kernels": kernels,
            "idle_s": idle_s, "idle_self_s": idle_s}


ON_CARD = {"pydca/fit": _row(6000, 2.4, idle_s=0.2), "pydca/plm/mm": _row(161, 1.9),
           "pydca/identity_counts": _row(2, 1.3e-3)}


@pytest.mark.parametrize("name", NEW)
def test_reader_without_a_program_table_reads_nothing(name):
    read = reader(name)
    assert read(_run(None)) is None
    run = _run({})
    run.profile.pop("program")
    assert read(run) is None
    assert read(_run({})) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_off_the_card_reads_nothing(name):
    cpu = {n: _row(0, 0.0, idle_s=r["idle_s"] + 1.0) for n, r in ON_CARD.items()}
    assert reader(name)(_run(cpu)) is None


@pytest.mark.parametrize("name, value", [
    ("lbfgs_host_ms_per_iter", 1e3 * 0.2 / 80),
    ("fit_nonproduct_ms_per_iter", 1e3 * 0.5 / 80),
    ("fit_kernels_per_iter", 6000 / 80),
    ("identity_counts_kernel_roofline", 100.0 * identity_bound(16384, 195, 21)[0] / 1.3e-3),
])
def test_reader_on_the_card(name, value):
    assert reader(name)(_run(ON_CARD)) == pytest.approx(value, rel=1e-3)
