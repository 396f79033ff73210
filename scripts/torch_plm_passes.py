"""The fused plmDCA step's passes (``csrc/plm_passes.cu``) on one GPU.

    env PYTHONPATH=. python scripts/torch_plm_passes.py

At the benchmark's shape, N = 16384, L = 195, q = 21 (and at 4097 x 117,
q 5), it makes carried logits, picks, a direction and weights on the card
from a seed, and for ``ops/cuda_kernels.plm_trial`` and
``plm_update_grad`` (with a direction) prints: how far the kernel lies from
its plain composition run on the card (the sums over the sums of their
terms' magnitudes; elementwise in float32 ulps of the terms), how far each
of the two lies from float64 (the trial's sums over 17 step lengths, the
column sums gh), whether two
launches agree to the bit, the time of a call (CUDA events with the
wrapper, mean of 20 after a warm-up), the device time of its kernels
(torch.profiler), the bound by bytes at 3.35 TB/s (each input read once,
each output written once), and the plain composition's time.  Then it
traces one job of the benchmark cell ``pf02826_16k.plm`` and lists the
device operations launched under the spans ``pydca/plm/trial`` and
``pydca/plm/gradient`` by name, and the ``aten::`` operators called under
them with an input of N*q*L elements.  First it
prints the card's name and power limit and what ``nvcc -Xptxas -v``
reports for the kernels (registers, spills).  One JSON line at the end;
exits 1 when a kernel is outside the tolerances of
``tests/test_torch_kernels_gpu.py`` or does not repeat.  Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile

import torch

from chip_smoke import cuda_ms, device_ms, ulps
from chip_smoke import plm_pass_problem as problem
from pydca_tpu_torch.device import set_precision
from pydca_tpu_torch.ops import _build
from pydca_tpu_torch.ops import cuda_kernels as ck
from pydca_tpu_torch.plm import _pick_mask

SHAPES = ((16384, 195, 21), (4097, 117, 5))  # N, L, q
HBM = 3.35e12  # bytes/s, H100 SXM at 700 W
ALPHA = 0.37


def compiler_report() -> None:
    nvcc = _build.find_nvcc()
    src = str(_build.CSRC / "plm_passes.cu")
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.path.join(tmp, "lib.so"), src],
            capture_output=True, text=True, check=True)
    for line in proc.stderr.splitlines():
        name = re.search(r"Compiling entry function '(\S+)'", line)
        if name:
            print(f"ptxas {name.group(1)}:", end="")
        elif "spill" in line or "Used" in line:
            print(" " + line.split(":", 1)[-1].strip(), end="" if "spill" in line else "\n")
    print(flush=True)


def trial64(p, alpha=ALPHA):
    """The trial's two sums in float64, and the sums of their terms' magnitudes."""
    d = {k: v.double() if v.is_floating_point() else v for k, v in p.items()}
    up = d["u"] + d["dh"].T[None]
    upk = up.gather(1, d["codes"].long()[:, None, :])[:, 0, :]
    t = d["logits"] + alpha * up
    w = d["weights"][:, None]
    f = w * (torch.logsumexp(t, 1) - d["picked"] - alpha * upk)
    s = w * ((torch.softmax(t, 1) * up).sum(1) - upk)
    return torch.stack((f.sum(), s.sum())), torch.stack((f.abs().sum(), s.abs().sum()))


def sum_errors(p, alphas):
    """Over ``alphas``: the largest and the root-mean-square error of the
    kernel's and of the plain composition's trial sums against float64, over
    the sums of their terms' magnitudes."""
    errs = {"kernel": [], "plain": []}
    for alpha in alphas:
        args = (p["logits"], p["codes"], p["weights"], p["picked"], p["u"], p["dh"], alpha)
        exact, sizes = trial64(p, alpha)
        for name, fn in (("kernel", ck.plm_trial), ("plain", ck.plm_trial_reference)):
            errs[name].append(((fn(*args).double() - exact).abs() / sizes).tolist())
    out = {}
    for name, e in errs.items():
        e = torch.tensor(e)  # (alphas, 2)
        out[name] = {"max": e.max(0).values.tolist(), "rms": e.pow(2).mean(0).sqrt().tolist()}
    return out


def measure(n, l, q, dev):
    p = problem(n, l, q, seed=n + l + q, dev=dev)
    nql = n * q * l
    res = {"n": n, "l": l, "q": q}
    # the trial
    args = (p["logits"], p["codes"], p["weights"], p["picked"], p["u"], p["dh"], ALPHA)
    got, again = ck.plm_trial(*args), ck.plm_trial(*args)
    want = ck.plm_trial_reference(*args)
    rel = ((got.double() - want.double()).abs() / trial64(p)[1]).tolist()
    trial_bytes = 4 * (2 * nql + n * l + n + l * q) + n * l + 8
    res["trial"] = {
        "sum_err_over_terms": rel, "repeats": bool(torch.equal(got, again)),
        "ms": cuda_ms(lambda: ck.plm_trial(*args), 20),
        "device_ms": device_ms(lambda: ck.plm_trial(*args), ("plm_trial",), 20),
        "bound_ms": 1e3 * trial_bytes / HBM,
        "plain_ms": cuda_ms(lambda: ck.plm_trial_reference(*args), 10),
        "err_vs_float64": sum_errors(p, [k / 16 for k in range(17)]),
    }
    del got, again, want
    # the update and the gradient's cotangent
    step = (p["u"], p["dh"], ALPHA)
    lg, pk = p["logits"].clone(), p["picked"].clone()
    ct, gh = ck.plm_update_grad(lg, p["codes"], p["weights"], pk, *step)
    lg2, pk2 = p["logits"].clone(), p["picked"].clone()
    ct2, gh2 = ck.plm_update_grad(lg2, p["codes"], p["weights"], pk2, *step)
    repeats = all(torch.equal(a, b) for a, b in ((lg, lg2), (pk, pk2), (ct, ct2), (gh, gh2)))
    del lg2, pk2, ct2, gh2
    lg_t, pk_t = p["logits"].clone(), p["picked"].clone()
    ct_t, gh_t = ck.plm_update_grad_reference(lg_t, p["codes"], p["weights"], pk_t, *step)
    gh64 = ((torch.softmax(lg.double(), 1) - _pick_mask(p["codes"], q).double())
            * p["weights"].double()[:, None, None]).sum(0)
    scale = ct_t.abs().sum(0).double()
    grad = {
        "gh_err_vs_float64": {"kernel": float(((gh - gh64).abs() / scale).max()),
                              "plain": float(((gh_t - gh64).abs() / scale).max())},
        "logits_ulps": ulps(lg, lg_t, lg_t.abs()), "picked_ulps": ulps(pk, pk_t, pk_t.abs()),
        "ct_ulps_of_terms": ulps(ct, ct_t, ct_t.abs() + p["weights"][:, None, None]),
        "gh_err_over_terms": float(((gh - gh_t).abs() / ct_t.abs().sum(0)).max()),
        "logits_equal": bool(torch.equal(lg, lg_t)), "repeats": repeats,
    }
    del lg, pk, ct, gh, lg_t, pk_t, ct_t, gh_t
    lg, pk = p["logits"], p["picked"]  # updated in place by ALPHA * 1e-3 a call below
    small = (p["u"], p["dh"], 1e-3)

    def kernel():
        ck.plm_update_grad(lg, p["codes"], p["weights"], pk, *small)

    def plain():
        ck.plm_update_grad_reference(lg, p["codes"], p["weights"], pk, *small)

    grad_bytes = 4 * (4 * nql + 2 * n * l + n + 2 * l * q) + n * l
    grad.update(ms=cuda_ms(kernel, 20),
                device_ms=device_ms(kernel, ("plm_update_grad", "plm_gh_reduce"), 20),
                bound_ms=1e3 * grad_bytes / HBM, plain_ms=cuda_ms(plain, 10))
    res["update_grad"] = grad
    return res


def job_kernels(cell_name="pf02826_16k.plm", seed=2718281829,
                spans=("pydca/plm/trial", "pydca/plm/gradient")):
    """The device operations launched under each of ``spans`` in one traced
    job of ``cell_name`` (after a warm-up job), by name: count, device
    seconds and the longest one."""
    from dcabench.harness import engine_options, make_pool, set_caches
    from dcabench.jobs import run_job
    from dcabench.spec import ROOT, load_cell
    from pydca_tpu_torch.runtime import enable_compilation_cache

    set_caches(ROOT)
    enable_compilation_cache(os.environ["PYDCA_TPU_CACHE_DIR"])
    cell = load_cell(cell_name, ROOT)
    pool, opts = make_pool(cell, seed), engine_options(cell)

    def job():
        return run_job(cell.traffic["engine"], 0, 0, pool[0], cell.config["biomolecule"],
                       torch.device("cuda"), opts)

    job()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        rec, _ = job()
    c = cell.config
    big = c["num_seqs"] * c["q"] * c["seqs_len"]
    operators = {}
    for e in prof.events():
        if not e.name.startswith("aten::") or not any(
                math.prod(s) == big for s in e.input_shapes if s):
            continue
        anc = e.cpu_parent
        while anc is not None and anc.name not in spans:
            anc = anc.cpu_parent
        if anc is not None:
            key = f"{anc.name}: {e.name}"
            operators[key] = operators.get(key, 0) + 1
    cpu = torch.autograd.DeviceType.CPU
    opened = {s: [] for s in spans}
    launch, device = {}, []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() * 1e-9
        b = a + e.duration_ns() * 1e-9
        if e.device_type() != cpu:
            device.append((e.correlation_id(), e.name(), b - a))
        elif e.name().startswith("cu"):
            launch[e.correlation_id()] = a
        elif e.name() in opened:
            opened[e.name()].append((a, b))
    out = {s: {} for s in spans}
    for corr, name, dt in device:
        t = launch.get(corr)
        for s, ivs in opened.items():
            if t is not None and any(a <= t <= b for a, b in ivs):
                row = out[s].setdefault(name[:90], [0, 0.0, 0.0])
                row[0] += 1
                row[1] += dt
                row[2] = max(row[2], dt)
    return rec.fit, out, operators


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_plm_passes: no CUDA card", file=sys.stderr)
        return 1
    set_precision()
    dev = torch.device("cuda")
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip(), flush=True)
    compiler_report()
    results = []
    ok = True
    for n, l, q in SHAPES:
        r = measure(n, l, q, dev)
        results.append(r)
        t, g = r["trial"], r["update_grad"]
        print(f"plm_trial N={n} L={l} q={q}: {t['ms']:.4f} ms (device {t['device_ms']:.4f}), "
              f"bound {t['bound_ms']:.4f} ms by bytes ({100 * t['bound_ms'] / t['device_ms']:.1f}%"
              f" of it), plain {t['plain_ms']:.4f} ms; sums off by {t['sum_err_over_terms']} of "
              f"their terms; repeats {t['repeats']}; against float64 over 17 steps "
              f"{t['err_vs_float64']}", flush=True)
        print(f"plm_update_grad N={n} L={l} q={q}: {g['ms']:.4f} ms (device "
              f"{g['device_ms']:.4f}), bound {g['bound_ms']:.4f} ms by bytes "
              f"({100 * g['bound_ms'] / g['device_ms']:.1f}% of it), plain {g['plain_ms']:.4f} ms;"
              f" logits {g['logits_ulps']:.2f} ulps (equal {g['logits_equal']}), picked "
              f"{g['picked_ulps']:.2f}, ct {g['ct_ulps_of_terms']:.2f} ulps of its terms, gh off "
              f"by {g['gh_err_over_terms']:.3g} of its terms, against float64 "
              f"{g['gh_err_vs_float64']}; repeats {g['repeats']}", flush=True)
        ok &= (t["repeats"] and g["repeats"] and max(t["sum_err_over_terms"]) <= 1e-6
               and g["logits_ulps"] <= 2 and g["picked_ulps"] <= 2
               and g["ct_ulps_of_terms"] <= 10 and g["gh_err_over_terms"] <= 1e-6)
        torch.cuda.empty_cache()
    fit, under, operators = job_kernels()
    print(f"one traced job of pf02826_16k.plm ({fit}): device operations by the span open at "
          "their launch (count, device s, longest s):", flush=True)
    for span_name, rows in under.items():
        for name, (count, total, longest) in sorted(rows.items(), key=lambda kv: -kv[1][1]):
            print(f"  {span_name}: {name}: {count}, {total:.6f}, {longest:.6f}", flush=True)
    print(f"  aten operators with an (N, q, L) input under them (calls): {operators}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "shapes": results,
                      "job_kernels": under, "nql_operators": operators}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
