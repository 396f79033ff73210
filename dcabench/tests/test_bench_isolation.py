"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program.  Module names are compared by
their top-level name, whole: the program's name begins with the JAX
package's."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "pydca_tpu"}

LOAD_ALL = """
import json, sys
from pathlib import Path
import dcabench.run, dcabench.harness, dcabench.calibrate, dcabench.jobs, dcabench.trace
import dcabench.reference.judge, dcabench.reference.plm, dcabench.reference.meanfield
from dcabench.spec import reader
bench = json.loads(Path("BENCHMARK.json").read_text())
for m in bench["end_to_end"] + bench["per_layer"]:
    reader(m["name"])
for w in bench["workloads"]:
    json.loads(Path("dcabench/traffic", w["traffic"] + ".json").read_text())
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

LOAD_REFERENCE = """
import json, sys
import dcabench.reference, dcabench.reference.judge, dcabench.reference.plm
import dcabench.reference.meanfield, dcabench.reference.weights
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_imports_no_jax():
    names = _top_level(LOAD_ALL)
    assert "pydca_tpu_torch" in names  # the system under test is loaded ...
    assert not names & FORBIDDEN  # ... and nothing of JAX or its package


def test_reference_imports_nothing_of_the_program():
    names = _top_level(LOAD_REFERENCE)
    assert "torch" in names
    assert not names & (FORBIDDEN | {"pydca_tpu_torch"})
