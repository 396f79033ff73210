"""A checkout of the benchmark with toy cells added as files and entries
only, for the CPU tests: ``toy.plm``, ``toy.mf`` and the two-rank
``toy.mesh2``, at sizes a CPU run holds."""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
FAMILY = {"n_pairs": 4, "n_ancestors": 16, "mutation": 0.15, "couple_prob": 0.9,
          "gap_share": 0.1, "concentration": 0.5}
POOL = {"cells": 0, "min": 2, "max": 2}  # two families, ordered by --seed
TOY_LIMITS = {
    "plm": {"weights_max_abs": 0.0, "objective_gap": 1e-6, "stop_gap": 3e-6,
            "fnapc_gap": 1e-5, "list_errors": 0.0},
    "mf": {"weights_max_abs": 0.0, "couplings_gap": 1e-4, "fnapc_gap": 1e-4, "list_errors": 0.0},
}


def _add(metrics, names, cell, template=None):
    """List ``cell`` under each named metric, adding the metric's entry
    from ``template`` where ``BENCHMARK.json`` has none (its reader is a
    file of ``dcabench/metrics/``)."""
    for name in names:
        entry = next((m for m in metrics if m["name"] == name), None)
        if entry is None:
            entry = dict(template, name=name, workloads=[])
            metrics.append(entry)
        if "workloads" in entry:
            entry["workloads"].append(cell)


def write_toy_root(root: Path) -> Path:
    """Copy ``BENCHMARK.json`` and ``dcabench/`` into ``root`` and add the toy
    configuration, mixes, limits and cells as new files and entries."""
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "dcabench", root / "dcabench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__", "tests"))
    d = root / "dcabench"
    (d / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "biomolecule": "protein", "num_seqs": 256, "seqs_len": 24, "q": 21,
         "precision": "float32"}))
    (d / "traffic" / "toy_plm.json").write_text(json.dumps(
        {"engine": "plm", "options": {"max_iterations": 100, "seqid": 0.8}, "pool": POOL,
         "check": 2, "family": FAMILY}))
    (d / "traffic" / "toy_mf.json").write_text(json.dumps(
        {"engine": "mf", "options": {"seqid": 0.8, "pseudocount": 0.5}, "pool": POOL,
         "check": 3, "family": FAMILY}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "a toy", "file": "dcabench/configs/toy.json",
                             "reduced": [], "why": "CPU tests"})
    for cell, traffic, chips, kind in (("toy.plm", "toy_plm", 1, "plm"),
                                       ("toy.mf", "toy_mf", 1, "mf"),
                                       ("toy.mesh2", "toy_plm", 2, "plm")):
        bench["workloads"].append({"name": cell, "config": "toy", "traffic": traffic,
                                   "chips": chips, "why": "CPU tests"})
        (d / "limits" / f"{cell}.json").write_text(json.dumps(TOY_LIMITS[kind]))
    seconds = {"unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"}
    share = {"unit": "%", "better": "lower", "source": "program_span", "layer": "score",
             "moves": "mf_family_s"}
    collectives = {"unit": "%", "better": "lower", "source": "program_span",
                   "layer": "collectives", "moves": "plm_family_s"}
    _add(bench["end_to_end"], ["plm_family_s"], "toy.plm")
    _add(bench["end_to_end"], ["plm_family_s"], "toy.mesh2")
    _add(bench["end_to_end"], ["mf_family_s", "family_p95_s"], "toy.mf", seconds)
    _add(bench["per_layer"], ["host_syncs_per_iter"], "toy.plm")
    _add(bench["per_layer"], ["plm_mfu"], "toy.mesh2")
    _add(bench["per_layer"], ["collective_share"], "toy.mesh2", collectives)
    _add(bench["per_layer"], ["mf_score_share"], "toy.mf", share)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="session")
def toy_root(tmp_path_factory):
    return write_toy_root(tmp_path_factory.mktemp("checkout"))


def result_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])
