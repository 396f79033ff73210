"""What ``BENCHMARK.json`` names, found by name: a cell's configuration
file, its traffic mix (``dcabench/traffic/<traffic>.json``), its limits
(``dcabench/limits/<cell>.json``) and the reader of each metric it reports
(``dcabench/metrics/<metric>.py``, a module with ``read(run)``).

A later cell, mix, configuration or metric is new files and new entries in
``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics a run reports: the per-layer ones with ``--trace 1``."""
        return self.per_layer if trace else self.end_to_end


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _listed(metric: dict, cell: str) -> Optional[bool]:
    names = metric.get("workloads")
    return None if names is None else cell in names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}; "
                       f"have {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _listed(m, name) is not False]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _listed(m, name) or (_listed(m, name) is None and m["moves"] in e2e_names)]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=_read_json(root / conf["file"]),
        traffic=_read_json(root / "dcabench" / "traffic" / f"{w['traffic']}.json"),
        limits=_read_json(root / "dcabench" / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=per_layer,
        root=root,
    )


def reader(metric: str, root: Path = ROOT) -> Callable:
    """The ``read`` function of ``dcabench/metrics/<metric>.py``."""
    path = root / "dcabench" / "metrics" / f"{metric}.py"
    module_name = "dcabench_metric_" + metric.replace(".", "_")
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
