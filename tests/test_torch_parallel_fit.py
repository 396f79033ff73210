"""Sequence-sharded fits of the port on real processes, against the JAX package.

The module spawns itself as the worker (``python test_torch_parallel_fit.py
worker ...``): 2 (and, for the weights, 3) processes on the CPU, each a rank
of a gloo group that meets at a ``FileStore`` under the test's temporary
directory, each holding a stripe of the rows.  The workers import torch and
the port only; they save what they computed, and the JAX side runs here, in
the pytest process, on the 8 virtual CPU devices of ``tests/conftest.py``.
One spawn serves every check of its fixture.
"""

import os
import sys

import numpy as np
import torch

# ---------------------------------------------------------------- the worker
# (above the JAX imports: a worker process imports torch and the port only)
TIMEOUT_S = 120  # each spawn's communicate(); a group's collectives time out at 60 s
TOY_N, TOY_L, TOY_Q = 97, 10, 5  # N odd: the 2- and 3-rank stripes have pads


def _toy(n=TOY_N, l=TOY_L, q=TOY_Q, seed=0):
    """``tests/test_parallel_fit.py::_toy`` at an N that no world size divides."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, q, (4, l))
    msa = base[rng.integers(0, 4, n)]
    mut = rng.random((n, l)) < 0.25
    return np.where(mut, rng.integers(0, q, (n, l)), msa).astype(np.int32)


def _worker(rank: int, world: int, store: str, indir: str, outdir: str, task: str) -> None:
    from datetime import timedelta

    import torch.distributed as dist

    from pydca_tpu_torch import plm as tplm
    from pydca_tpu_torch import stats as tstats
    from pydca_tpu_torch.parallel import (
        fit_plm_sharded, init_distributed, make_mesh, mfdca_sharded, read_msa_distributed,
        sequence_weights_sharded, shard_msa,
    )

    torch.set_num_threads(1)
    init_distributed("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                     timeout=timedelta(seconds=60))
    mesh = make_mesh(device="cpu")
    inp = np.load(os.path.join(indir, "inputs.npz"))
    toy = inp["toy"]
    codes, _, valid = shard_msa(mesh, toy)
    out = {
        "weights": tstats.sequence_weights(codes, 0.8, TOY_Q, valid=valid, mesh=mesh).numpy(),
        "weights_full": sequence_weights_sharded(mesh, toy, 0.8, TOY_Q).numpy(),
        "codes": codes.numpy(), "valid": valid.numpy(),
    }
    if task == "fits":
        res = fit_plm_sharded(codes, biomolecule_q=TOY_Q, valid=valid, mesh=mesh,
                              max_iterations=10)
        out.update(fused_x=res.x.numpy(), fused_fx=res.fx, fused_k=res.num_iters,
                   fused_evals=res.n_evals)
        out["fused_trials"] = mesh.collectives["nll_allreduce"][0]
        out["fused_grads"] = mesh.collectives["grad_allreduce"][0]
        res = fit_plm_sharded(codes, biomolecule_q=TOY_Q, valid=valid, mesh=mesh,
                              max_iterations=5, seq_block=8)
        out.update(stream_x=res.x.numpy(), stream_fx=res.fx, stream_k=res.num_iters)
        fam = inp["family"]
        fcodes, _, fvalid = shard_msa(mesh, fam)
        res = fit_plm_sharded(fcodes, biomolecule_q=5, valid=fvalid, mesh=mesh,
                              max_iterations=100)
        out.update(long_x=res.x.numpy(), long_k=res.num_iters)
        # bfloat16 products, and a w2 request, on the same rows
        res = fit_plm_sharded(fcodes, biomolecule_q=5, valid=fvalid, mesh=mesh,
                              max_iterations=100, mm_bf16=True)
        out.update(bf16_x=res.x.numpy(), bf16_k=res.num_iters)
        res = fit_plm_sharded(fcodes, biomolecule_q=5, valid=fvalid, mesh=mesh,
                              max_iterations=100, param_space="w2")
        out.update(w2_x=res.x.numpy(), w2_k=res.num_iters)
        # mean-field: float64 weights keep float64; float32 weights computed
        m_codes, w64, m_valid = shard_msa(mesh, inp["mf"], torch.from_numpy(inp["mf_w64"]))
        fn, apc, cpl = mfdca_sharded(m_codes, biomolecule_q=5, weights=w64, mesh=mesh,
                                     return_couplings=True)
        out.update(mf64_fn=fn.numpy(), mf64_apc=apc.numpy(), mf64_couplings=cpl.numpy())
        fn, apc = mfdca_sharded(m_codes, biomolecule_q=5, valid=m_valid, mesh=mesh)
        out.update(mf32_fn=fn.numpy(), mf32_apc=apc.numpy())
        # checkpoints: stop at 5 iterations, resume to 10; count the writers
        writes = []
        save = tplm._save_state
        tplm._save_state = lambda path, st: (writes.append(path), save(path, st))
        ck = os.path.join(outdir, "ck.npz")
        kw = dict(biomolecule_q=TOY_Q, valid=valid, mesh=mesh, checkpoint_path=ck)
        res5 = fit_plm_sharded(codes, max_iterations=5, **kw)
        res = fit_plm_sharded(codes, max_iterations=10, **kw)
        tplm._save_state = save
        out.update(ck_k5=res5.num_iters, ck_x=res.x.numpy(), ck_fx=res.fx, ck_k=res.num_iters,
                   ck_writes=len(writes))
        # the reader over the real gloo transport
        sharded = read_msa_distributed(os.path.join(indir, "dups.fa"), "rna")
        out.update(read_data=sharded.local_data, read_valid=sharded.local_valid,
                   read_ids=np.array(sharded.ids), read_n=sharded.global_num_seqs)
    if task == "grid":
        out.update(_grid_worker(inp))
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def _grid_worker(inp) -> dict:
    """The ('data', 'model') grids of 4 ranks: 2 x 2 and 1 x 4."""
    from pydca_tpu_torch.alphabets import RNA
    from pydca_tpu_torch.io.fasta import MSA
    from pydca_tpu_torch.meanfield import MeanFieldDCA
    from pydca_tpu_torch.parallel import fit_plm_sharded, make_mesh, mfdca_sharded, shard_msa

    grids = {"22": make_mesh(2, 2, device="cpu"), "14": make_mesh(1, 4, device="cpu")}
    out = {}

    def mf_case(name, grid, msa, q, w64=None):
        if w64 is None:
            m_codes, _, m_valid = shard_msa(grid, msa)
            fn, apc, rows = mfdca_sharded(m_codes, biomolecule_q=q, valid=m_valid, mesh=grid,
                                          return_couplings=True)
        else:
            m_codes, w, _ = shard_msa(grid, msa, torch.from_numpy(w64))
            fn, apc, rows = mfdca_sharded(m_codes, biomolecule_q=q, weights=w, mesh=grid,
                                          return_couplings=True)
        out.update({f"{name}_fn": fn.numpy(), f"{name}_apc": apc.numpy(),
                    f"{name}_rows": rows.rows.numpy(), f"{name}_range": [rows.start, rows.stop]})

    for tag, grid in grids.items():
        mf_case(f"g{tag}_64", grid, inp["mf"], 5, inp["mf_w64"])
        mf_case(f"g{tag}_32", grid, inp["mf"], 5)
        out[f"g{tag}_model_rank"] = grid.model_rank
    # 15 sites over 4 slabs: C padded to 16 sites
    mf_case("pad_64", grids["14"], inp["mf15"], 5, inp["mf15_w64"])
    # D = 4200 > 4096: the blocked Cholesky on the slabs
    grids["22"].collectives.clear()
    mf_case("big_64", grids["22"], inp["big"], 21, inp["big_w64"])
    out["big_chol_bcasts"] = grids["22"].collectives.get("chol_rows_bcast", [0])[0]
    # plm on the 2 x 2 grid: data-parallel, replicated over the model axis
    p_codes, _, p_valid = shard_msa(grids["22"], inp["toy"])
    res = fit_plm_sharded(p_codes, biomolecule_q=TOY_Q, valid=p_valid, mesh=grids["22"],
                          max_iterations=10)
    out["grid_plm_x"] = res.x.numpy()
    # the engine on the 1 x 4 grid: FN-APC from the slabs, the couplings gathered once
    eng = MeanFieldDCA(MSA(data=inp["mf"].astype(np.int8), alphabet=RNA), "rna", device="cpu",
                       mesh=grids["14"])
    out["engine_apc"] = np.array([s for _, s in sorted(eng.compute_sorted_FN_APC())])
    out["engine_rows"] = eng.coupling_rows().rows.numpy()
    out["engine_couplings"] = eng.compute_couplings().numpy()
    # a non-SPD C (3 sequences, pseudocount 0): the LU fallback on a grid
    lu = np.array([[0, 1, 2, 3, 0, 1], [1, 2, 3, 0, 1, 2], [2, 3, 0, 1, 2, 3]], dtype=np.int8)
    eng = MeanFieldDCA(MSA(data=lu, alphabet=RNA), "rna", pseudocount=0.0, device="cpu",
                       mesh=grids["22"])
    out["lu_engine_fn"] = np.array([s for _, s in sorted(eng.compute_sorted_FN())])
    out["lu_engine_flag"] = eng.lu_fallback
    l_codes, _, l_valid = shard_msa(grids["14"], lu)
    fn, _ = mfdca_sharded(l_codes, biomolecule_q=5, valid=l_valid, pseudocount=0.0,
                          mesh=grids["14"])
    out["lu_fn"] = fn.numpy()
    return out


if __name__ == "__main__":
    _worker(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:8])
    sys.exit(0)

# ---------------------------------------------------------------- the tests
import subprocess  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from pydca_tpu import plm as jplm  # noqa: E402
from pydca_tpu import stats as jstats  # noqa: E402
from pydca_tpu.parallel import data as jdata  # noqa: E402
from pydca_tpu.parallel import (  # noqa: E402
    fit_plm_sharded as j_fit_plm_sharded,
    make_mesh as j_make_mesh,
    mfdca_sharded as j_mfdca_sharded,
    sequence_weights_sharded as j_sequence_weights_sharded,
)
from pydca_tpu_torch import score as tscore  # noqa: E402
from pydca_tpu_torch import stats as tstats  # noqa: E402
from pydca_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from pydca_tpu_torch.synthetic import planted_family, spearman, top_k_overlap  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn(tmp, world: int, task: str):
    """Run ``world`` worker processes of this file; their saved results."""
    store, outdir = os.path.join(tmp, "store"), os.path.join(tmp, "out")
    os.makedirs(outdir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(r), str(world), store, tmp,
         outdir, task],
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
    return [dict(np.load(os.path.join(outdir, f"rank{r}.npz"))) for r in range(world)], outdir


def _write_fasta(path, rows, letters="ACGU-"):
    with open(path, "w") as fh:
        for k, r in enumerate(rows):
            fh.write(f">s{k}\n" + "".join(letters[int(x)] for x in r) + "\n")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_mp"))
    mf, _ = planted_family(203, 16, 5, seed=5, n_pairs=4)
    mf_w64 = np.asarray(tstats.sequence_weights(torch.tensor(mf), 0.8, 5), np.float64)
    family, _ = planted_family(301, 24, 5, seed=7, n_pairs=6, n_ancestors=16)
    mf15, _ = planted_family(203, 15, 5, seed=6, n_pairs=4)
    mf15_w64 = np.asarray(tstats.sequence_weights(torch.tensor(mf15), 0.8, 5), np.float64)
    big = _toy(n=96, l=210, q=21, seed=2)
    big_w64 = np.asarray(tstats.sequence_weights(torch.tensor(big), 0.8, 21), np.float64)
    np.savez(os.path.join(tmp, "inputs.npz"), toy=_toy(), mf=mf, mf_w64=mf_w64, family=family,
             mf15=mf15, mf15_w64=mf15_w64, big=big, big_w64=big_w64)
    rng = np.random.default_rng(11)
    base = rng.integers(0, 5, size=(6, 20))
    dups = base[rng.integers(0, 6, size=121)]
    dups = np.where(rng.random(dups.shape) < 0.1, rng.integers(0, 5, size=dups.shape), dups)
    _write_fasta(os.path.join(tmp, "dups.fa"), dups)
    return tmp, dict(mf=mf, mf_w64=mf_w64, family=family, mf15=mf15, mf15_w64=mf15_w64,
                     big=big, big_w64=big_w64)


@pytest.fixture(scope="module")
def two_ranks(inputs):
    return spawn(inputs[0], 2, "fits")


@pytest.fixture(scope="module")
def three_ranks(inputs, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_mp3"))
    os.symlink(os.path.join(inputs[0], "inputs.npz"), os.path.join(tmp, "inputs.npz"))
    return spawn(tmp, 3, "weights")[0]


@pytest.fixture(scope="module")
def grid_ranks(inputs, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_grid"))
    os.symlink(os.path.join(inputs[0], "inputs.npz"), os.path.join(tmp, "inputs.npz"))
    return spawn(tmp, 4, "grid")[0]


def gathered(ranks, key):
    """The ranks' stripes of ``key`` in rank order, cut back to N rows."""
    return np.concatenate([r[key] for r in ranks])


def fn_apc_sorted(x, l, q):
    p = l * (l - 1) // 2
    blocks = torch.tensor(np.asarray(x, np.float32))[l * q :].reshape(p, q, q)
    return tscore.sorted_scores(tscore.apc(tscore.frobenius_norms(blocks[:, : q - 1, : q - 1]), l), l)


def jax_fit_on_stripes(ranks, **kw):
    """The JAX one-device fit on the workers' padded layout (their stripes
    concatenated, pads at weight 0), as ``tests/test_multiprocess.py`` does."""
    msa = gathered(ranks, "codes").astype(np.int32)
    w = gathered(ranks, "weights")
    lam = jnp.float32(0.2 * (TOY_L - 1))
    return jplm.fit_plm(jnp.asarray(msa), jnp.asarray(w), lam, lam, TOY_L, TOY_Q,
                        mm_bf16=False, **kw)


# ------------------------------------------------------------------ counts
@pytest.mark.parametrize("n", [1, 128, 129, 300, 700])
def test_tile_partials_sum_to_full_counts(n):
    """Any split of the tile list into ranges: the ranges' partial counts
    sum to the full count exactly, with and without a valid mask."""
    rng = np.random.default_rng(n)
    l, q = 12, 4
    codes = torch.tensor(rng.integers(0, q, (n, l)).astype(np.int8))
    codes[n // 2 :] = codes[: n - n // 2].clone()  # identical rows: counts above 1
    valid = torch.tensor(rng.random(n) > 0.2)
    side = -(-n // 128)
    total = side * (side + 1) // 2
    for v in (None, valid):
        full = ck.identity_counts(codes, 0.7 * l, q, valid=v)
        for _ in range(4):
            cuts = np.sort(rng.integers(0, total + 1, 3))
            edges = [0, *cuts.tolist(), total]
            parts = sum(ck.identity_counts(codes, 0.7 * l, q, valid=v, tiles=(a, b))
                        for a, b in zip(edges[:-1], edges[1:]))
            assert torch.equal(parts, full)
        shares = [ck.identity_tile_share(n, r, 3) for r in range(3)]
        assert shares[0][0] == 0 and shares[-1][1] == total
        assert all(a[1] == b[0] for a, b in zip(shares[:-1], shares[1:]))
        assert torch.equal(sum(ck.identity_counts(codes, 0.7 * l, q, valid=v, tiles=t)
                               for t in shares), full)


def test_tile_share_sizes():
    """The balanced shares of the tile counts the deep shapes give."""
    for n, total in ((16384, 8256), (100000, 306153)):
        shares = [ck.identity_tile_share(n, r, 2) for r in range(2)]
        assert shares[-1][1] == total
        assert abs((shares[0][1] - shares[0][0]) - (shares[1][1] - shares[1][0])) <= 1
    with pytest.raises(ValueError, match="outside"):
        ck.identity_counts(torch.zeros((10, 3), dtype=torch.int8), 1.0, 2, tiles=(0, 2))


# ------------------------------------------------------------------ weights
@pytest.mark.parametrize("world", [2, 3])
def test_sharded_weights_exact(two_ranks, three_ranks, world):
    """The ranks' weights: exactly JAX's sharded weights and the port's
    one-device weights, 0 on the pads, the same full vector on every rank."""
    ranks = two_ranks[0] if world == 2 else three_ranks
    toy = _toy()
    w = gathered(ranks, "weights")
    assert w.shape[0] % world == 0 and (w[TOY_N:] == 0).all()
    want_jax = np.asarray(j_sequence_weights_sharded(j_make_mesh(), toy, 0.8, TOY_Q))
    want_port = tstats.sequence_weights(torch.tensor(toy), 0.8, TOY_Q).numpy()
    np.testing.assert_array_equal(w[:TOY_N], want_port)
    np.testing.assert_array_equal(w[:TOY_N], want_jax.astype(np.float32))
    for r in ranks:
        np.testing.assert_array_equal(r["weights_full"], want_port)


# ------------------------------------------------------------------ plm fits
def test_fused_fit_matches_jax_sharded(two_ranks):
    """10 iterations on 2 ranks: theta bitwise equal across the ranks and,
    against JAX's ``fit_plm_sharded`` on the 8 virtual devices, the same
    iterations, fx to 1e-5 and theta to 1e-3 (``tests/test_parallel_fit.py``'s bar)."""
    r0, r1 = two_ranks[0]
    np.testing.assert_array_equal(r0["fused_x"], r1["fused_x"])
    want = j_fit_plm_sharded(_toy(), biomolecule_q=TOY_Q, max_iterations=10,
                             mesh=j_make_mesh(), mm_bf16=False)
    assert int(r0["fused_k"]) == int(want.num_iters)
    np.testing.assert_allclose(float(r0["fused_fx"]), float(want.fx), rtol=1e-5)
    np.testing.assert_allclose(r0["fused_x"], np.asarray(want.x), rtol=1e-3, atol=1e-3)


def test_fused_fit_one_collective_per_trial(two_ranks):
    """Each evaluation of phi reads one 2-element collective (the state's
    first included), and each gradient one D-element collective."""
    r0 = two_ranks[0][0]
    assert int(r0["fused_trials"]) == int(r0["fused_evals"])
    assert int(r0["fused_grads"]) == int(r0["fused_k"]) + 1


def test_streamed_fit_matches_jax(two_ranks):
    """``seq_block=8``, 5 iterations on 2 ranks against JAX's streamed fit
    on the same rows: fx to 1e-5, theta to 2e-3 (``tests/test_multiprocess.py``)."""
    ranks = two_ranks[0]
    np.testing.assert_array_equal(ranks[0]["stream_x"], ranks[1]["stream_x"])
    want = jax_fit_on_stripes(ranks, max_iterations=5, seq_block=8)
    assert int(ranks[0]["stream_k"]) == int(want.num_iters)
    np.testing.assert_allclose(float(ranks[0]["stream_fx"]), float(want.fx), rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["stream_x"], np.asarray(want.x), rtol=2e-3, atol=2e-3)


def test_long_fused_fit_meets_rank_bar(two_ranks, inputs):
    """100 iterations on 2 ranks against the JAX one-device fit: FN-APC
    Spearman >= 0.98 and top-20 overlap >= 0.9."""
    ranks = two_ranks[0]
    np.testing.assert_array_equal(ranks[0]["long_x"], ranks[1]["long_x"])
    fam = inputs[1]["family"].astype(np.int32)
    l, q = fam.shape[1], 5
    w = jstats.sequence_weights(jnp.asarray(fam), 0.8, q)
    lam = jnp.float32(0.2 * (l - 1))
    want = jplm.fit_plm(jnp.asarray(fam), w, lam, lam, l, q, max_iterations=100, mm_bf16=False)
    got_s, want_s = fn_apc_sorted(ranks[0]["long_x"], l, q), fn_apc_sorted(want.x, l, q)
    assert spearman(got_s, want_s, l) >= 0.98
    assert top_k_overlap(got_s, want_s, 20) >= 0.9


@pytest.mark.parametrize("case", ["bf16", "w2"])
def test_bf16_and_w2_fits_meet_rank_bar(two_ranks, inputs, case):
    """100 iterations on 2 ranks, with bfloat16 products or under a w2
    request, against the JAX one-device fit with the same options: theta
    equal on both ranks, FN-APC at the rank bar.  The w2 request fits the
    compact layout: its theta is the two-rank compact fit's, bit for
    bit."""
    ranks = two_ranks[0]
    np.testing.assert_array_equal(ranks[0][f"{case}_x"], ranks[1][f"{case}_x"])
    fam = inputs[1]["family"].astype(np.int32)
    l, q = fam.shape[1], 5
    w = jstats.sequence_weights(jnp.asarray(fam), 0.8, q)
    lam = jnp.float32(0.2 * (l - 1))
    kw = dict(mm_bf16=True) if case == "bf16" else dict(param_space="w2")
    want = jplm.fit_plm(jnp.asarray(fam), w, lam, lam, l, q, max_iterations=100, **kw)
    got_s, want_s = fn_apc_sorted(ranks[0][f"{case}_x"], l, q), fn_apc_sorted(want.x, l, q)
    assert spearman(got_s, want_s, l) >= 0.98
    assert top_k_overlap(got_s, want_s, 20) >= 0.9
    if case == "w2":
        np.testing.assert_array_equal(ranks[0]["w2_x"], ranks[0]["long_x"])


# ------------------------------------------------------------------ mean field
def test_meanfield_f64_matches_jax_sharded(two_ranks, inputs):
    """Float64 weights on 2 ranks against JAX's ``mfdca_sharded`` with the
    same float64 weights: FN, FN-APC and couplings to rtol 1e-8."""
    r0, r1 = two_ranks[0]
    mf, w64 = inputs[1]["mf"], inputs[1]["mf_w64"]
    fn, apc, cpl = j_mfdca_sharded(mf, biomolecule_q=5, weights=jnp.asarray(w64),
                                   mesh=j_make_mesh(), return_couplings=True)
    for key, want in (("mf64_fn", fn), ("mf64_apc", apc), ("mf64_couplings", cpl)):
        assert r0[key].dtype == np.float64
        np.testing.assert_array_equal(r0[key], r1[key])
        np.testing.assert_allclose(r0[key], np.asarray(want), rtol=1e-8, atol=1e-12)


def test_meanfield_f32_meets_rank_bar(two_ranks, inputs):
    """Float32 weights computed over the ranks, against JAX's float32
    ``mfdca_sharded``: the rank bar."""
    r0 = two_ranks[0][0]
    mf = inputs[1]["mf"]
    l = mf.shape[1]
    _, apc = j_mfdca_sharded(mf, biomolecule_q=5, mesh=j_make_mesh())
    got = tscore.sorted_scores(torch.tensor(r0["mf32_apc"]), l)
    want = tscore.sorted_scores(torch.tensor(np.asarray(apc, np.float32)), l)
    assert spearman(got, want, l) >= 0.98 and top_k_overlap(got, want, 20) >= 0.9


# ------------------------------------------------------------------ checkpoints
def test_checkpoint_resume_matches_uninterrupted(two_ranks):
    """Stopped at 5 iterations and resumed to 10 on 2 ranks: the iteration
    count of the uninterrupted 2-rank fit and its theta to 1e-5 (the resume
    rebuilds the logits and the history caches: float recompute, not bitwise)."""
    r0, r1 = two_ranks[0]
    assert int(r0["ck_k5"]) == 5
    np.testing.assert_array_equal(r0["ck_x"], r1["ck_x"])
    assert int(r0["ck_k"]) == int(r0["fused_k"])
    np.testing.assert_allclose(float(r0["ck_fx"]), float(r0["fused_fx"]), rtol=1e-6)
    np.testing.assert_allclose(r0["ck_x"], r0["fused_x"], rtol=1e-5, atol=1e-5)


def test_checkpoint_one_writer_jax_loads_it(two_ranks):
    """Only rank 0 wrote (twice: at 5 iterations and at 10), and the file is
    the generic format that ``pydca_tpu.plm`` resumes."""
    (r0, r1), outdir = two_ranks
    assert int(r0["ck_writes"]) == 2 and int(r1["ck_writes"]) == 0
    st = jplm._load_state(os.path.join(outdir, "ck.npz"))
    assert int(st.k) == int(r0["ck_k"])
    np.testing.assert_array_equal(np.asarray(st.x), r0["ck_x"])


# ------------------------------------------------------------------ the reader
def test_reader_over_gloo_matches_jax_simulation(two_ranks, inputs):
    """``read_msa_distributed`` over the real gloo transport, 2 processes:
    each process's rows, mask and ids equal the JAX reader's (simulated)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    ranks = two_ranks[0]
    path = os.path.join(inputs[0], "dups.fa")
    barrier, slots = threading.Barrier(2), [None, None]

    def allgather_for(p):
        def ag(local):
            slots[p] = local
            barrier.wait()
            out = list(slots)
            barrier.wait()
            return out
        return ag

    with ThreadPoolExecutor(2) as ex:
        want = [f.result(timeout=60) for f in [
            ex.submit(jdata.read_msa_distributed, path, "rna", process_id=p, num_processes=2,
                      allgather_fn=allgather_for(p)) for p in range(2)]]
    for r, w in zip(ranks, want):
        np.testing.assert_array_equal(r["read_data"], w.local_data)
        np.testing.assert_array_equal(r["read_valid"], w.local_valid)
        assert list(r["read_ids"]) == w.ids
        assert int(r["read_n"]) == w.global_num_seqs


# ------------------------------------------------------------------ the model axis
GRIDS = {"22": (2, 2), "14": (1, 4)}
F32_TOL = dict(rtol=1e-4, atol=1e-6)  # tests/test_parallel_fit.py:67


def _jax_grid(msa, q, grid, w64=None):
    """JAX's ``mfdca_sharded`` on a (data, model) mesh of the 8 virtual devices."""
    kw = {} if w64 is None else dict(weights=jnp.asarray(w64))
    fn, apc, cpl = j_mfdca_sharded(msa, biomolecule_q=q, mesh=j_make_mesh(*GRIDS[grid]),
                                   return_couplings=True, **kw)
    return np.asarray(fn), np.asarray(apc), np.asarray(cpl)


def _rows_in_model_order(ranks, name, grid):
    """The slabs of the ranks of data index 0, stacked in model order."""
    n_model = GRIDS[grid][1]
    return np.concatenate([r[f"{name}_rows"] for r in ranks[:n_model]])


@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_meanfield_f64_matches_jax(grid_ranks, inputs, grid):
    """Float64 weights on a 2 x 2 and a 1 x 4 grid against JAX's
    ``mfdca_sharded`` on the same mesh: FN, FN-APC and the couplings' rows
    to rtol 1e-8, the same on every rank; each rank's rows are its model
    index's slab, whole sites."""
    fn, apc, cpl = _jax_grid(inputs[1]["mf"], 5, grid, inputs[1]["mf_w64"])
    name = f"g{grid}_64"
    d = cpl.shape[0]
    for r in grid_ranks:
        np.testing.assert_allclose(r[f"{name}_fn"], fn, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(r[f"{name}_apc"], apc, rtol=1e-8, atol=1e-12)
        start, stop = (int(x) for x in r[f"{name}_range"])
        per = d // GRIDS[grid][1]
        assert (start, stop) == (int(r[f"g{grid}_model_rank"]) * per,
                                 (int(r[f"g{grid}_model_rank"]) + 1) * per)
        assert r[f"{name}_rows"].dtype == np.float64
        np.testing.assert_allclose(r[f"{name}_rows"], cpl[start:stop], rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_meanfield_f32_matches_jax(grid_ranks, inputs, grid):
    """Float32 weights computed over the data axis, on each grid, against
    JAX's float32 ``mfdca_sharded`` on the same mesh: FN and FN-APC at
    rtol 1e-4, atol 1e-6; bitwise equal on every rank."""
    fn, apc, _ = _jax_grid(inputs[1]["mf"], 5, grid)
    r0 = grid_ranks[0]
    for r in grid_ranks:
        np.testing.assert_array_equal(r[f"g{grid}_32_apc"], r0[f"g{grid}_32_apc"])
    np.testing.assert_allclose(r0[f"g{grid}_32_fn"], fn, **F32_TOL)
    np.testing.assert_allclose(r0[f"g{grid}_32_apc"], apc, **F32_TOL)


def test_grid_pads_a_cut_site(grid_ranks, inputs):
    """15 sites over a model axis of 4: C is padded to 16 sites (an
    identity block), and FN, FN-APC and the real rows still match JAX's
    1 x 4 mesh to rtol 1e-8; the last rank holds 3 real sites."""
    fn, apc, cpl = _jax_grid(inputs[1]["mf15"], 5, "14", inputs[1]["mf15_w64"])
    np.testing.assert_allclose(grid_ranks[0]["pad_64_fn"], fn, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(grid_ranks[0]["pad_64_apc"], apc, rtol=1e-8, atol=1e-12)
    rows = _rows_in_model_order(grid_ranks, "pad_64", "14")
    assert rows.shape == cpl.shape and grid_ranks[3]["pad_64_rows"].shape[0] == 3 * 4
    np.testing.assert_allclose(rows, cpl, rtol=1e-8, atol=1e-12)


def test_grid_blocked_cholesky_above_4096(grid_ranks, inputs):
    """L 210, q 21 (D 4200 > 4096) on the 2 x 2 grid, float64 weights: the
    blocked Cholesky runs on the slabs (its row broadcasts counted), as
    JAX's does on its mesh; FN and FN-APC at rtol 1e-8.  (In float32 JAX's
    own FN here is 4.1e-4 off its float64 FN, the port's 1.1e-4: the
    comparison is made in float64.)"""
    fn, apc, _ = _jax_grid(inputs[1]["big"], 21, "22", inputs[1]["big_w64"])
    r0 = grid_ranks[0]
    assert int(r0["big_chol_bcasts"]) > 0
    np.testing.assert_allclose(r0["big_64_fn"], fn, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(r0["big_64_apc"], apc, rtol=1e-8, atol=1e-12)


def test_grid_plm_fit_bitwise_across_model_replicas(grid_ranks, two_ranks):
    """10 iterations on the 2 x 2 grid: theta bitwise equal on all four
    ranks and to the 2-rank data mesh's (the same stripes, the same sums)."""
    want = two_ranks[0][0]["fused_x"]
    for r in grid_ranks:
        np.testing.assert_array_equal(r["grid_plm_x"], want)


def test_grid_engine_gathers_couplings_once(grid_ranks):
    """``MeanFieldDCA(mesh=1 x 4 grid)``: its FN-APC equals
    ``mfdca_sharded``'s on the same grid, its rows are that run's slab,
    and ``compute_couplings`` gathers the slabs whole."""
    for r in grid_ranks:
        np.testing.assert_allclose(r["engine_apc"], r["g14_32_apc"], rtol=1e-6)
        np.testing.assert_allclose(r["engine_rows"], r["g14_32_rows"], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(np.concatenate([r["engine_rows"] for r in grid_ranks]),
                                  grid_ranks[0]["engine_couplings"])


def test_grid_lu_fallback(grid_ranks):
    """A non-SPD C (3 sequences, pseudocount 0) on a grid: every rank
    takes the LU fallback, as the one-device engine does, with its FN."""
    data = np.array([[0, 1, 2, 3, 0, 1], [1, 2, 3, 0, 1, 2], [2, 3, 0, 1, 2, 3]], dtype=np.int8)
    from pydca_tpu_torch.alphabets import RNA
    from pydca_tpu_torch.io.fasta import MSA
    from pydca_tpu_torch.meanfield import MeanFieldDCA

    one = MeanFieldDCA(MSA(data=data, alphabet=RNA), "rna", pseudocount=0.0, device="cpu")
    want = np.array([s for _, s in sorted(one.compute_sorted_FN())])
    assert one.lu_fallback
    for r in grid_ranks:
        assert bool(r["lu_engine_flag"])
        np.testing.assert_allclose(r["lu_engine_fn"], want, rtol=1e-5, equal_nan=True)
        np.testing.assert_allclose(r["lu_fn"], r["lu_engine_fn"], rtol=1e-5, equal_nan=True)
