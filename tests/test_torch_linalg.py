"""The port's blocked Cholesky, triangular inverse, SYRK and SPD inverse
against the JAX package's (``pydca_tpu/ops/linalg.py``), on one device and
on the row slabs of a model axis of 2 and 4 ranks.

The module spawns itself as the worker (``python test_torch_linalg.py
worker <rank> <world> <store> <outdir>``): gloo ranks on the CPU that meet
at a ``FileStore`` in the test's temporary directory, a (1, world) grid,
each holding a row slab of C.  The workers import torch and the port only;
the JAX side runs here, in the pytest process, on the 8 virtual CPU
devices of ``tests/conftest.py``.
"""

import os
import sys

import numpy as np
import torch

# ---------------------------------------------------------------- the worker
# (above the JAX imports: a worker process imports torch and the port only)
TIMEOUT_S = 120  # each spawn's communicate(); a group's collectives time out at 60 s
BLOCK = 128  # chol_block and the triangular inverse's base block on the slabs
# (n, dtype, seed): n 300 is 15 sites of q-1 = 20 rows, which 2 and 4 slabs cut
CASES = [(512, "float32", 2), (512, "float64", 3), (300, "float64", 4)]
TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "float64": dict(rtol=1e-8, atol=1e-10)}


def _spd(n, seed=0, dtype=np.float64):
    """``tests/test_linalg.py::_spd``."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n)).astype(dtype)
    return a @ a.T + n * np.eye(n, dtype=dtype)


def _worker(rank: int, world: int, store: str, outdir: str) -> None:
    from datetime import timedelta

    import torch.distributed as dist
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from pydca_tpu_torch.ops import linalg as tl
    from pydca_tpu_torch.parallel import init_distributed, make_mesh

    class Largest(TorchDispatchMode):
        """The largest tensor any op creates while it is active."""

        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.numel = max(self.numel, t.numel())
            return out

    torch.set_num_threads(1)
    init_distributed("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                     timeout=timedelta(seconds=60))
    mesh = make_mesh(1, world, device="cpu")
    out = {}
    for n, dtype, seed in CASES:
        tag = f"{n}_{dtype}"
        c = _spd(n, seed, getattr(np, dtype))
        s = n // world
        rows = slice(rank * s, (rank + 1) * s)
        slab = torch.from_numpy(np.ascontiguousarray(c[rows]))
        fac, info = tl.cholesky_blocked(slab, BLOCK, mesh)
        lower = np.linalg.cholesky(c.astype(np.float64)).astype(c.dtype)
        w = tl.tri_inv_lower(torch.from_numpy(np.ascontiguousarray(lower[rows])), BLOCK, mesh)
        mesh.collectives.clear()
        largest = Largest()
        with largest:
            inv, inv_info = tl.spd_inverse(slab, block=BLOCK, chol_block=BLOCK, mesh=mesh)
        out.update({f"chol_{tag}": fac.numpy(), f"chol_info_{tag}": int(info),
                    f"tri_{tag}": w.numpy(), f"inv_{tag}": inv.numpy(),
                    f"inv_info_{tag}": int(inv_info), f"largest_{tag}": largest.numel,
                    f"rs_{tag}": mesh.collectives["syrk_reduce_scatter"][0],
                    f"a2a_{tag}": mesh.collectives["sym_all_to_all"][0]})
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    sys.exit(0)

# ---------------------------------------------------------------- the tests
import subprocess  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from pydca_tpu.ops import linalg as jl  # noqa: E402
from pydca_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from pydca_tpu_torch.ops import linalg as tl  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn(tmp, world: int):
    """Run ``world`` worker processes of this file; their saved results."""
    store, outdir = os.path.join(tmp, "store"), os.path.join(tmp, "out")
    os.makedirs(outdir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(r), str(world), store, outdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=tmp,
    ) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"
    return [dict(np.load(os.path.join(outdir, f"rank{r}.npz"))) for r in range(world)]


@pytest.fixture(scope="module")
def slabs(tmp_path_factory):
    return {world: spawn(str(tmp_path_factory.mktemp(f"linalg{world}")), world)
            for world in (2, 4)}


def _jax_sharded_inverse(c):
    """JAX's ``spd_inverse(chol_block=128)`` with C row-sharded over an
    8-way model axis (replicated where 8 does not divide n)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = j_make_mesh(n_data=1, n_model=8)

    @jax.jit
    def run(cm):
        cm = jax.lax.with_sharding_constraint(cm, NamedSharding(mesh, P("model", None)))
        return jl.spd_inverse(cm, chol_block=BLOCK)

    with jax.set_mesh(mesh):
        return np.asarray(run(jnp.asarray(c)))


# ------------------------------------------------------------- one device
@pytest.mark.parametrize("n,block", [(64, 256), (300, 128), (700, 256)])
def test_cholesky_blocked_matches_jax(n, block):
    """``tests/test_linalg.py``'s cases: JAX's blocked factor to rtol 1e-9,
    the strict upper triangle exactly zero, info 0."""
    c = _spd(n)
    want = np.asarray(jl.cholesky_blocked(jnp.asarray(c), block))
    got, info = tl.cholesky_blocked(torch.from_numpy(c), block)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)
    assert (np.triu(got.numpy(), k=1) == 0).all()
    assert int(info) == 0


def test_spd_inverse_chol_block_matches_jax():
    """``spd_inverse(block=128, chol_block=128)`` at n 500 against JAX's and
    numpy's inverse to rtol 1e-8; the engine's route (no ``chol_block``)
    agrees too."""
    c = _spd(500, seed=1)
    want = np.asarray(jl.spd_inverse(jnp.asarray(c), block=128, chol_block=128))
    got, info = tl.spd_inverse(torch.from_numpy(c), block=128, chol_block=128)
    assert int(info) == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(got.numpy(), np.linalg.inv(c), rtol=1e-8, atol=1e-10)
    engine, _ = tl.spd_inverse(torch.from_numpy(c))
    np.testing.assert_allclose(engine.numpy(), want, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("n", [200, 513, 1000])
def test_tri_inv_lower_matches_jax(n):
    """The divide and conquer at base block 128 against JAX's, f64."""
    m = np.linalg.cholesky(_spd(n, seed=n))
    want = np.asarray(jl.tri_inv_lower(jnp.asarray(m), 128))
    got = tl.tri_inv_lower(torch.from_numpy(m), 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-12)
    assert (np.triu(got.numpy(), k=1) == 0).all()


def test_split_point():
    """The lane-aligned midpoint of ``pydca_tpu/ops/linalg.py:185``: a
    multiple of 128 at least 128 from either end."""
    for n, k in ((256, 128), (257, 128), (300, 172), (700, 384), (1000, 512), (4200, 2176),
                 (20000, 10112)):
        assert tl._split(n) == k
        assert n - k >= 128 and (k % 128 == 0 or k == n - 128)


# ------------------------------------------------------------- model axis
CASE_IDS = [f"{n}-{dtype}" for n, dtype, _ in CASES]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_sharded_inverse_matches_jax_and_one_process(slabs, world, case):
    """The ranks' slabs of ``spd_inverse(block=128, chol_block=128)``,
    gathered, against JAX's under an 8-way model axis and against the
    port's one process: f64 rtol 1e-8, f32 rtol and atol 2e-4 (JAX's
    ``tests/test_linalg.py:60``); info 0 on every rank; one reduce-scatter
    per 128 columns (the SYRK) and one all-to-all per 128 rows of a slab
    (the symmetrisation)."""
    n, dtype, seed = case
    tag = f"{n}_{dtype}"
    c = _spd(n, seed, getattr(np, dtype))
    got = np.concatenate([r[f"inv_{tag}"] for r in slabs[world]])
    assert got.dtype == getattr(np, dtype) and got.shape == (n, n)
    np.testing.assert_allclose(got, _jax_sharded_inverse(c), **TOL[dtype])
    one, _ = tl.spd_inverse(torch.from_numpy(c), block=BLOCK, chol_block=BLOCK)
    np.testing.assert_allclose(got, one.numpy(), **TOL[dtype])
    for r in slabs[world]:
        assert int(r[f"inv_info_{tag}"]) == 0
        assert int(r[f"rs_{tag}"]) == -(-n // BLOCK)
        assert int(r[f"a2a_{tag}"]) == -(-(n // world) // BLOCK)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_sharded_factor_and_tri_inv_match_one_process(slabs, world, case):
    """The ranks' slabs of ``cholesky_blocked`` and ``tri_inv_lower`` at
    block 128, gathered, against the port's one process (and so JAX's, by
    the one-device tests) at the dtype's tolerance."""
    n, dtype, seed = case
    tag = f"{n}_{dtype}"
    c = _spd(n, seed, getattr(np, dtype))
    fac = np.concatenate([r[f"chol_{tag}"] for r in slabs[world]])
    one, _ = tl.cholesky_blocked(torch.from_numpy(c), BLOCK)
    np.testing.assert_allclose(fac, one.numpy(), **TOL[dtype])
    assert (np.triu(fac, k=1) == 0).all()
    assert all(int(r[f"chol_info_{tag}"]) == 0 for r in slabs[world])
    lower = np.linalg.cholesky(c.astype(np.float64)).astype(c.dtype)
    w = np.concatenate([r[f"tri_{tag}"] for r in slabs[world]])
    np.testing.assert_allclose(w, tl.tri_inv_lower(torch.from_numpy(lower), BLOCK).numpy(),
                               **TOL[dtype])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_sharded_solve_creates_no_full_matrix(slabs, world, case):
    """No tensor the sharded solve creates (a ``TorchDispatchMode`` over
    ``spd_inverse`` in the worker) holds more than D^2 / P + 2 D block
    elements: the CPU's twin of JAX's
    ``test_sharded_solve_does_not_replicate_factor``."""
    n, dtype, _ = case
    for r in slabs[world]:
        largest = int(r[f"largest_{n}_{dtype}"])
        assert largest <= n * n // world + 2 * n * BLOCK and largest < n * n
