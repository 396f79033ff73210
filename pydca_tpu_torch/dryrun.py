"""Entry points: one plm loss evaluation, and the multi-rank dryrun.

Port of ``__graft_entry__.py``.  :func:`entry` returns one plmDCA
pseudolikelihood loss and gradient evaluation on torch tensors (the hot
op: every L-BFGS iteration is a handful of these).
:func:`dryrun_multichip` runs, on a ('data', 'model') grid of ranks, the
sharded weights, two fused L-BFGS iterations, a streamed fit of two
iterations and the model-sharded mean-field pipeline at D = 2560, and
holds three results to one process: the weights exactly, the fused
iterations' theta to float tolerance, and the Gram summed over the data
axis to 1e-6 relative.

    python -m pydca_tpu_torch.dryrun [--n K] [--device cuda|cuda:K|cpu]

Under ``torchrun`` each process is one rank.  Otherwise the command starts
its K ranks itself (:func:`~pydca_tpu_torch.parallel.spawn.spawn_cli`):
``cuda`` puts one rank on each card under NCCL (K defaults to the visible
cards), ``cuda:K`` puts every rank on card K under gloo, and ``cpu`` runs
gloo ranks on the CPU (K defaults to 4).  Unlike the JAX package's dryrun,
nothing switches to another device: asking for more cards than are
visible raises.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["dryrun_multichip", "entry"]

THETA_TOL = (1e-4, 1e-5)  # (rtol, atol): two f32 iterations, sums in another order
GRAM_RTOL = 1e-6  # the data-summed Gram against one process's, relative to its largest entry


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _tiny_problem(n=64, l=12, q=5, seed=0):
    """``__graft_entry__._tiny_problem``: 4 ancestors, 25% point mutations."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, q, size=(4, l))
    msa = base[rng.integers(0, 4, size=n)]
    mut = rng.random((n, l)) < 0.25
    return np.where(mut, rng.integers(0, q, size=(n, l)), msa).astype(np.int32)


def entry(device="cuda"):
    """``(fn, example_args)``: one plmDCA loss and gradient at N 256, L 32,
    q 5 (``__graft_entry__.entry``), on ``device`` (a card unless the
    caller asks for the CPU; ``"cuda"`` without one raises)."""
    from .device import resolve_device
    from .plm import plm_loss_and_grad

    device = resolve_device(device)
    n, l, q = 256, 32, 5
    msa = torch.from_numpy(_tiny_problem(n=n, l=l, q=q)).to(device)
    p = l * (l - 1) // 2
    d = l * q + p * q * q
    rng = np.random.default_rng(1)
    theta = torch.tensor(rng.normal(scale=0.01, size=d), dtype=torch.float32, device=device)
    weights = torch.ones(n, dtype=torch.float32, device=device)
    lam = 0.2 * (l - 1)

    def fn(theta, msa, weights, lambda_h, lambda_j):
        return plm_loss_and_grad(theta, msa, weights, lambda_h, lambda_j, l, q)

    return fn, (theta, msa, weights, lam, lam)


def _where(world: int, device: str) -> str:
    """How the ranks are placed, for the report line."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return f"{world} gloo rank(s) on the CPU"
    if dev.index is None:
        return f"{world} NCCL rank(s), one a card"
    return f"{world} gloo rank(s) sharing card {dev}"


def _check_cards(world: int, device: str) -> None:
    """Raise when the device asks for cards that are not visible."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    want = world if dev.index is None else dev.index + 1
    if want > count:
        raise RuntimeError(f"the dryrun on {device!r} with {world} rank(s) needs "
                           f"{want} card(s); {count} are visible")


def dryrun_multichip(n_devices: int, device: str = "cuda") -> Optional[str]:
    """One sharded training step and the model-sharded mean-field pipeline
    on an ``n_devices``-rank grid (``__graft_entry__.dryrun_multichip``).

    A model axis of 2 when ``n_devices`` is even and at least 4, else 1;
    the data axis takes the rest.  In a process group of ``n_devices``
    ranks this runs this rank's part and returns the report line (rank 0
    prints it); without one, ``n_devices`` ranks are started on
    ``device`` (see the module; the cards unless the caller asks for the
    CPU) and this returns ``None`` once they succeed, raising when one
    fails.  Raises ``RuntimeError`` when ``device`` asks for cards that are
    not visible, and ``AssertionError`` when a check fails.
    """
    from .parallel.fit import launch_mesh
    from .parallel.mesh import torchrun_world

    _check_cards(n_devices, device)
    if dist.is_initialized() or torchrun_world() > 1:
        _, dev = launch_mesh("auto", device)
    elif n_devices > 1:
        from .parallel.spawn import spawn_cli

        code = spawn_cli(_run_rank, ["--n", str(n_devices), "--device", device],
                         n_devices, device)
        if code:
            raise RuntimeError(f"a dryrun rank failed (exit {code})")
        return None
    else:  # one rank, this process
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise ValueError(f"the dryrun asks for {n_devices} ranks; the process group has {world}")
    return _dryrun_rank(n_devices, torch.device(dev), _where(world, device))


def _dryrun_rank(n_devices: int, dev: torch.device, where: str) -> str:
    from . import stats
    from .parallel import make_mesh, mfdca_sharded, shard_msa
    from .plm import _plm_fused_state0, _plm_fused_steps, _prep_msa, fit_plm

    n_model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(n_devices // n_model, n_model, device=dev)

    l, q = 12, 5
    n = max(64, 8 * n_devices)
    msa_np = _tiny_problem(n=n, l=l, q=q)
    # weights on the data-sharded alignment, pads masked (the engines' path)
    codes, _, valid = shard_msa(mesh, msa_np)
    w = stats.sequence_weights(codes, 0.8, q, valid=valid, mesh=mesh)
    lam = 0.2 * (l - 1)

    # fused L-BFGS init and two iterations, data-parallel over the sequences
    x1h, maskq = _prep_msa(codes, l, q)
    state = _plm_fused_state0(codes, w, lam, lam, l, q, 5, mesh=mesh)
    state = _plm_fused_steps(state, x1h, maskq, w, lam, lam, l, q, 2, mesh=mesh)
    _check(state.k >= 1, "no L-BFGS iteration executed")

    # the streamed fit over the mesh (the deep-alignment path)
    res_stream = fit_plm(codes, w, lam, lam, l, q, max_iterations=2,
                         seq_block=max(16, n // 4), mesh=mesh)
    _check(res_stream.num_iters >= 1, "no streaming iteration executed")

    # the mean-field pipeline through the model-sharded solve at D = 2560
    l_mf, q_mf = 128, 21
    msa_mf = _tiny_problem(n=max(128, 8 * n_devices), l=l_mf, q=q_mf, seed=1)
    mf_codes, _, mf_valid = shard_msa(mesh, msa_mf)
    out = mfdca_sharded(mf_codes, biomolecule_q=q_mf, valid=mf_valid, mesh=mesh,
                        return_all=True)
    fn_apc = out["fn_apc"]
    _check(tuple(out["fn"].shape) == (l_mf * (l_mf - 1) // 2,), "FN of the wrong shape")
    _check(bool(torch.isfinite(fn_apc).all()), "non-finite FN-APC")

    # the three checks against one process on the whole alignments
    full = torch.from_numpy(msa_np).to(dev)
    w_one = stats.sequence_weights(full, 0.8, q)
    w_all = mesh.gather_rows(w, "dryrun_gather")[:n]
    _check(torch.equal(w_all, w_one), "sharded weights differ from one process's")
    one = _plm_fused_state0(full, w_one, lam, lam, l, q, 5)
    one = _plm_fused_steps(one, *_prep_msa(full, l, q), w_one, lam, lam, l, q, 2)
    diff = (state.x - one.x).abs()
    rtol, atol = THETA_TOL
    _check(state.k == one.k and bool((diff <= atol + rtol * one.x.abs()).all()),
           f"theta after {state.k} iterations off one process's: max |diff| "
           f"{float(diff.max()):.3e}")
    gram = stats.weighted_gram(mf_codes, out["weights"], q_mf, mesh=mesh)
    mf_full = torch.from_numpy(msa_mf).to(dev)
    gram_one = stats.weighted_gram(mf_full, stats.sequence_weights(mf_full, 0.8, q_mf), q_mf)
    gram_err = float((gram - gram_one).abs().max() / gram_one.abs().max())
    _check(gram_err <= GRAM_RTOL, f"data-summed Gram off one process's: {gram_err:.3e} relative")

    line = (f"dryrun_multichip OK: mesh {{'data': {mesh.world_size}, 'model': {n_model}}}, "
            f"plm step k={state.k}, streaming k={res_stream.num_iters}, "
            f"mf D={l_mf * (q_mf - 1)} fn_apc {tuple(fn_apc.shape)}; {where}; against one "
            f"process: weights equal, theta max |diff| {float(diff.max()):.3e} (rtol, atol "
            f"{THETA_TOL}), Gram {gram_err:.3e} relative (<= {GRAM_RTOL})")
    if mesh.leader:
        print(line, flush=True)
    return line


def _parse(argv: Optional[Sequence[str]]):
    parser = argparse.ArgumentParser(prog="python -m pydca_tpu_torch.dryrun",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=None,
                        help="ranks (default: the visible cards for 'cuda', else 4)")
    parser.add_argument("--device", default="cuda", help="cuda, cuda:K or cpu")
    args = parser.parse_args(argv)
    if args.n is None:
        dev = torch.device(args.device)
        if dev.type == "cuda" and dev.index is None:
            args.n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if args.n == 0:
                raise RuntimeError("--device cuda, but no card is visible")
        else:
            args.n = int(os.environ.get("WORLD_SIZE", "4"))
    return args


def _run_rank(argv: Sequence[str]) -> None:
    """One rank started by :func:`dryrun_multichip` (a module-level
    function: the spawned ranks import it by name)."""
    args = _parse(argv)
    dryrun_multichip(args.n, args.device)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parse(argv)
    _check_cards(args.n, args.device)
    dev = torch.device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    fn, fargs = entry(dev)
    loss, grad = fn(*fargs)
    if int(os.environ.get("RANK", "0")) == 0:
        print(f"entry OK: loss {float(loss):.6f}, grad {tuple(grad.shape)}", flush=True)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    from pydca_tpu_torch.dryrun import main as _main  # the spawned ranks import it by name

    sys.exit(_main())
