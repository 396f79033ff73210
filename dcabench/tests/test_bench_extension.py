"""A configuration, a traffic mix and a per-layer metric that a later change
adds as new files and new ``BENCHMARK.json`` entries alone are run by the
harness as it stands (on the CPU, the chip check skipped)."""

import json

from dcabench.harness import run_cell
from dcabench.spec import load_cell

from conftest import result_line, write_toy_root

TOY_METRIC = '''"""Jobs finished in the window: a toy per-layer metric."""


def read(run):
    return float(len(run.jobs))
'''


def test_new_files_and_entries_run(tmp_path, capfd):
    root = write_toy_root(tmp_path)
    (root / "dcabench" / "metrics" / "toy_jobs.py").write_text(TOY_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "toy_jobs", "unit": "jobs", "better": "higher",
                               "source": "program_counter", "layer": "toy",
                               "moves": "plm_family_s", "workloads": ["toy.plm"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell("toy.plm", root)
    assert cell.config["num_seqs"] == 256 and cell.traffic["pool"]["max"] == 2
    assert [m["name"] for m in cell.metrics(trace=True)] == ["host_syncs_per_iter", "toy_jobs"]

    assert run_cell("toy.plm", 2**33 + 5, 1.0, False, device="cpu", root=root) == 0
    plain = result_line(capfd.readouterr().out)
    assert plain["correct"] is True
    assert set(plain["metrics"]) == {"plm_family_s", "setup_s"}
    assert list(plain)[-1] == "checks"

    assert run_cell("toy.plm", 2**33 + 5, 1.0, True, device="cpu", root=root) == 0
    traced = result_line(capfd.readouterr().out)
    assert traced["correct"] is True
    assert traced["metrics"]["toy_jobs"]["value"] == traced["attempted"] >= 1
    assert traced["metrics"]["toy_jobs"]["unit"] == "jobs"
    assert {"busy_s", "window_s"} <= set(traced["device"])
