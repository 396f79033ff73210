"""One job: one family, from its codes in host memory, through a new
engine with the CLI's defaults, as ``plmdca``/``mfdca compute_fn --apc``
run it (the ranked file is not written).

plmDCA: ``PlmDCA(...)``, the weights, the fit
(``get_fields_and_couplings_from_backend``, which also brings the
parameters to the host), ``compute_sorted_FN_APC()``.  Mean-field:
``MeanFieldDCA(...)``, the weights, ``compute_couplings()``,
``compute_sorted_FN_APC()``.  Each call is a span of the benchmark's own
(``torch.profiler.record_function`` named ``dcabench/<span>``), so that a
trace can say which call the device and the host were in.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from pydca_tpu_torch.alphabets import get_alphabet
from pydca_tpu_torch.io.fasta import MSA
from pydca_tpu_torch.meanfield import MeanFieldDCA
from pydca_tpu_torch.parallel.mesh import make_mesh
from pydca_tpu_torch.plm import PlmDCA

SPAN_PREFIX = "dcabench/"
STAGES = {  # the engines' own synced stage timers
    "plm": ("weights", "fit", "score"),
    "mf": ("weights", "gram", "corr", "inverse", "score"),
}


@contextlib.contextmanager
def span(name: str):
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


@dataclass
class JobRecord:
    """What one job's run says about itself."""

    family: int
    wall: float
    stages: Dict[str, float]
    peak_bytes: int
    fit: Optional[Dict[str, int]] = None  # plm: num_iters, n_evals, host_syncs
    collectives: Dict[str, List[float]] = field(default_factory=dict)  # after the weights


@dataclass
class JobOutput:
    """What the job produced, for the comparison with the reference."""

    index: int
    family: int
    weights: torch.Tensor
    params: object  # plm: the host parameter vector; mf: the device couplings
    ranked: list
    iters: int = 0  # plm: the fit's L-BFGS iterations


def run_job(kind: str, index: int, family: int, codes: np.ndarray, biomolecule: str, device,
            options: dict, mesh_ranks: int = 1, timed_mesh: bool = False):
    """Run one job on fresh host arrays; returns ``(JobRecord, JobOutput)``.

    ``mesh_ranks`` above 1: the engine gets a data mesh over the default
    process group (one rank a card), ``timed_mesh`` synchronising around
    each collective to time it."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with span("job"):
        msa = MSA(data=codes.copy(), alphabet=get_alphabet(biomolecule))
        mesh = None
        if mesh_ranks > 1:
            mesh = make_mesh(device=dev)
            mesh.timed = timed_mesh
        with span("engine"):
            if kind == "plm":
                eng = PlmDCA(msa, biomolecule, device=dev, mesh=mesh, **options)
            else:
                eng = MeanFieldDCA(msa, biomolecule, device=dev, mesh=mesh, **options)
        with span("weights"):
            weights = (eng.compute_seqs_weight() if kind == "plm" else eng.get_sequences_weight())
        if mesh is not None:
            mesh.collectives.clear()
        with span("fit" if kind == "plm" else "solve"):
            params = (eng.get_fields_and_couplings_from_backend() if kind == "plm"
                      else eng.compute_couplings())
        with span("score"):
            ranked = eng.compute_sorted_FN_APC()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base if on_card else 0
    rec = JobRecord(family=family, wall=wall, peak_bytes=int(peak),
                    stages={s: eng.timers.elapsed(s) for s in STAGES[kind]},
                    collectives={} if mesh is None else dict(mesh.collectives))
    out = JobOutput(index=index, family=family, weights=weights, params=params, ranked=ranked)
    if kind == "plm":
        res = eng.fit_result
        rec.fit = {"num_iters": int(res.num_iters), "n_evals": int(res.n_evals),
                   "host_syncs": int(res.host_syncs)}
        out.iters = int(res.num_iters)
    return rec, out
