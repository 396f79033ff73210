"""Port's plm checkpoints (``fit_plm(checkpoint_path=...)``, ``--checkpoint``)
vs ``pydca_tpu``'s, on the CPU.

Inputs are made from a numpy seed.  The files: the same keys, shapes and
dtypes as the JAX package writes, and a save/load round trip returns every
leaf exactly.  Either package resumes the other's file, fused or generic:
five more iterations agree at the tolerance of the k = 0..5 states in
``tests/test_torch_plm.py`` (f rtol 1e-4, theta relative L2 <= 1e-3).  The
port's own interrupted-then-resumed fit equals the uninterrupted one bit
for bit (``tests/test_untested_features.py:42-62``).  The state conversions
agree with JAX's on the same state: fused -> generic exactly, generic ->
fused to float32 recompute.  The bounded retry recovers from a chunk that
fails half way through, leaving a state that must not be continued, and
raises where JAX does.  A w2-space file (``param_space="w2"``) written
by either package resumes in the other, a w2 fit resumes bit for bit, a
file in the other parameter space continues in its own space, and a
fused file with bfloat16 history rows resumes with bfloat16 rows in both
packages.
"""

import logging
import os
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pydca_tpu import plm as jplm
from pydca_tpu import stats as jstats
from pydca_tpu.cli import plmdca_main as jcli
from pydca_tpu_torch import alphabets as talph
from pydca_tpu_torch import plm as tplm
from pydca_tpu_torch.cli import plmdca_main as tcli
from pydca_tpu_torch.ops.lbfgs import LBFGSState
from pydca_tpu_torch.synthetic import planted_family, write_family_fasta

N, L, Q, M = 120, 10, 5, 5
BLOCK = 32  # the generic (streamed) route's sequence block


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def problem():
    codes, _ = planted_family(N, L, Q, seed=2, n_pairs=2, n_ancestors=8)
    msa = codes.astype(np.int32)
    w = np.asarray(jstats.sequence_weights(jnp.asarray(msa), 0.8, Q), np.float32)
    return msa, w, np.float32(0.2 * (L - 1))


def port_fit(problem, iters, ckpt=None, seq_block=None, every=5, **kw):
    msa, w, lam = problem
    return tplm.fit_plm(torch.tensor(msa), torch.tensor(w), float(lam), float(lam), L, Q,
                        max_iterations=iters, chunk_size=5, checkpoint_path=ckpt,
                        checkpoint_every=every, seq_block=seq_block, **kw)


def jax_fit(problem, iters, ckpt=None, seq_block=None, **kw):
    msa, w, lam = problem
    return jplm.fit_plm(jnp.asarray(msa), jnp.asarray(w), jnp.float32(lam), jnp.float32(lam),
                        L, Q, max_iterations=iters, chunk_size=5, checkpoint_path=ckpt,
                        checkpoint_every=5, seq_block=seq_block, **kw)


ROUTES = pytest.mark.parametrize("seq_block", [None, BLOCK], ids=["fused", "generic"])


def port_state(problem, seq_block, steps=3):
    """A port state after ``steps`` iterations on either route."""
    msa, w, lam = problem
    tm, tw = torch.tensor(msa), torch.tensor(w)
    if seq_block is None:
        st = tplm._plm_fused_state0(tm, tw, float(lam), float(lam), L, Q, M)
        x1h, codes = tplm._fused_inputs(tm, L, Q)
        return tplm._plm_fused_steps(st, x1h, codes, tw, float(lam), float(lam), L, Q, steps)
    st = tplm._plm_lbfgs_state0(tm, tw, float(lam), float(lam), L, Q, M, seq_block)
    return tplm._plm_lbfgs_steps(st, tm, tw, float(lam), float(lam), L, Q, steps, seq_block)


def leaves(st):
    names = [k for k in vars(st) if k != "host_syncs"]
    return {k: getattr(st, k) for k in names}


@ROUTES
def test_save_load_round_trip(tmp_path, problem, seq_block):
    st = port_state(problem, seq_block)
    path = str(tmp_path / "state.npz")
    tplm._save_state(path, st)
    back = tplm._load_state(path, "cpu")
    assert type(back) is type(st)
    want, got = leaves(st), leaves(back)
    assert set(want) == set(got)
    for key, a in want.items():
        b = got[key]
        if isinstance(a, torch.Tensor):
            assert b.dtype == a.dtype and torch.equal(a, b), key
        else:
            assert type(b) is type(a) and b == a, key


@ROUTES
def test_file_format_matches_jax(tmp_path, problem, seq_block):
    """Keys (in order), shapes and dtypes of the two packages' files for
    the same problem and budget."""
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_fit(problem, 5, pj, seq_block)
    port_fit(problem, 5, pt, seq_block)
    with np.load(pj) as fj, np.load(pt) as ft:
        assert ft.files == fj.files
        for key in fj.files:
            assert (ft[key].shape, ft[key].dtype) == (fj[key].shape, fj[key].dtype), key
        assert int(ft["k"]) == int(fj["k"]) == 5


def resume_both(tmp_path, problem, path, seq_block, iters=10, **kw):
    """Both packages resume copies of one file to ``iters`` iterations."""
    pj, pt = str(tmp_path / "rj.npz"), str(tmp_path / "rt.npz")
    shutil.copy(path, pj)
    shutil.copy(path, pt)
    rj = jax_fit(problem, iters, pj, seq_block, **kw)
    rt = port_fit(problem, iters, pt, seq_block, **kw)
    return rj, rt


@ROUTES
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_package_resume(tmp_path, problem, seq_block, writer):
    """A file written at k = 5 by either package, resumed by both for five
    more iterations on the route that wrote it."""
    path = str(tmp_path / "k5.npz")
    (jax_fit if writer == "jax" else port_fit)(problem, 5, path, seq_block)
    rj, rt = resume_both(tmp_path, problem, path, seq_block)
    assert rt.num_iters == int(rj.num_iters) == 10
    np.testing.assert_allclose(rt.fx, float(rj.fx), rtol=1e-4)
    assert rel_l2(rt.x.numpy(), np.asarray(rj.x)) <= 1e-3


@pytest.mark.parametrize("writer_block,reader_block", [(None, BLOCK), (BLOCK, None)],
                         ids=["fused_file_generic_loop", "generic_file_fused_loop"])
def test_resume_converts_between_formats(tmp_path, problem, writer_block, reader_block):
    """A file of the other format continues under the loop the flags ask
    for, in both packages (``pydca_tpu/plm.py:1277-1318``)."""
    path = str(tmp_path / "k5.npz")
    jax_fit(problem, 5, path, writer_block)
    rj, rt = resume_both(tmp_path, problem, path, reader_block)
    assert rt.num_iters == int(rj.num_iters) == 10
    np.testing.assert_allclose(rt.fx, float(rj.fx), rtol=1e-4)
    assert rel_l2(rt.x.numpy(), np.asarray(rj.x)) <= 1e-3


@ROUTES
def test_interrupted_resume_is_bitwise(tmp_path, problem, seq_block):
    full = port_fit(problem, 20, seq_block=seq_block)
    ckpt = str(tmp_path / "state")  # a bare path: .npz is appended
    part = port_fit(problem, 10, ckpt, seq_block)
    assert os.path.exists(ckpt + ".npz") and part.num_iters == 10
    resumed = port_fit(problem, 20, ckpt, seq_block)
    assert resumed.num_iters == full.num_iters == 20
    assert torch.equal(resumed.x, full.x)
    assert resumed.fx == full.fx and resumed.n_evals == full.n_evals


@pytest.fixture(scope="module")
def jax_fused_k3(problem):
    msa, w, lam = problem
    jmsa, jw, jlam = jnp.asarray(msa), jnp.asarray(w), jnp.float32(lam)
    x1h, maskq = jplm._prep_msa_jit(jmsa, L, Q)
    js = jplm._plm_fused_state0(jmsa, jw, jlam, jlam, L, Q, M)
    js = jplm._plm_fused_steps(js, x1h, maskq, jw, jlam, jlam, L, Q, 3)
    return js, x1h, maskq


def test_generic_from_fused_matches_jax(jax_fused_k3):
    js = jax_fused_k3[0]
    want = jax.device_get(jplm._generic_from_fused(js))
    got = tplm._generic_from_fused(tplm.fused_state_from_numpy(jax.device_get(js)._asdict(), "cpu"))
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.g.numpy(), np.asarray(want.g))
    np.testing.assert_array_equal(got.s_hist.numpy(), np.asarray(want.s_hist))
    np.testing.assert_array_equal(got.y_hist.numpy(), np.asarray(want.y_hist))
    np.testing.assert_array_equal(got.rho.numpy(), np.asarray(want.rho))
    assert (got.k, got.done, got.converged, got.ls_failed, got.n_evals) == (
        int(want.k), bool(want.done), bool(want.converged), bool(want.ls_failed),
        int(want.n_evals))


def test_fused_from_generic_matches_jax(problem, jax_fused_k3):
    """JAX's generic form of a k = 3 state, rebuilt into the fused state by
    both packages: the caches to float32 recompute."""
    msa, w, lam = problem
    js, x1h, maskq = jax_fused_k3
    gj = jplm._generic_from_fused(js)
    want = jax.device_get(jplm._fused_from_generic_jit(
        gj, x1h, maskq, jnp.asarray(w), jnp.float32(lam), jnp.float32(lam), L, Q, False))
    tm = torch.tensor(msa)
    tx, tcodes = tplm._fused_inputs(tm, L, Q)
    got = tplm._fused_from_generic(tplm.lbfgs_state_from_numpy(jax.device_get(gj)._asdict(), "cpu"),
                                   tx, tcodes, torch.tensor(w), float(lam), float(lam), L, Q)
    np.testing.assert_allclose(got.f, float(want.f), rtol=1e-6)
    for name in ("gg", "xx", "rh", "rj"):
        np.testing.assert_allclose(getattr(got, name), float(getattr(want, name)), rtol=1e-5)
    assert rel_l2(got.g.numpy(), np.concatenate([want.g[0], want.g[1]])) <= 1e-5
    np.testing.assert_allclose(got.logits.numpy(), want.logits, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.picked.numpy(), want.picked, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.zzt.numpy(), want.zzt, rtol=1e-5,
                               atol=1e-6 * np.abs(want.zzt).max())
    np.testing.assert_allclose(got.zg.numpy(), want.zg, rtol=1e-4,
                               atol=1e-5 * np.abs(want.zg).max())
    assert (got.k, got.done, got.converged, got.ls_failed, got.n_evals) == (
        int(want.k), bool(want.done), bool(want.converged), bool(want.ls_failed),
        int(want.n_evals))


def failing_steps(monkeypatch, seq_block, fail_on, exc=RuntimeError):
    """Patch the route's chunk function: on the calls in ``fail_on`` it
    advances the state by two steps, moves ``x`` alone as a step that stops
    half way would, and raises."""
    name = "_plm_fused_steps" if seq_block is None else "_plm_lbfgs_steps"
    real = getattr(tplm, name)
    calls = []

    def steps(st, *args):
        calls.append(len(calls) + 1)
        if len(calls) in fail_on:
            real(st, *args[:-1], 2) if seq_block is None else real(st, *args[:6], 2, args[-1])
            st.x.mul_(1.5)
            raise exc(f"injected fault on chunk {len(calls)}")
        return real(st, *args)

    monkeypatch.setattr(tplm, name, steps)
    return calls


def retry_warnings(caplog):
    return [r for r in caplog.records
            if r.levelno == logging.WARNING and "resuming from checkpoint" in r.getMessage()]


@ROUTES
def test_retry_recovers_from_the_file(tmp_path, monkeypatch, caplog, problem, seq_block):
    full = port_fit(problem, 20, seq_block=seq_block)
    failing_steps(monkeypatch, seq_block, {3})
    with caplog.at_level(logging.WARNING, logger="pydca_tpu_torch.plm"):
        res = port_fit(problem, 20, str(tmp_path / "ck.npz"), seq_block)
    assert len(retry_warnings(caplog)) == 1
    assert res.num_iters == full.num_iters
    assert torch.equal(res.x, full.x) and res.fx == full.fx


@pytest.mark.parametrize("ckpt,fail_on", [(False, {3}), (True, {1})],
                         ids=["no_checkpoint", "no_file_yet"])
def test_fault_without_a_file_propagates(tmp_path, monkeypatch, caplog, problem, ckpt, fail_on):
    failing_steps(monkeypatch, None, fail_on)
    with caplog.at_level(logging.WARNING, logger="pydca_tpu_torch.plm"):
        with pytest.raises(RuntimeError, match="injected fault"):
            port_fit(problem, 20, str(tmp_path / "ck.npz") if ckpt else None)
    assert not retry_warnings(caplog)


def test_third_fault_raises(tmp_path, monkeypatch, caplog, problem):
    calls = failing_steps(monkeypatch, None, {3, 4, 5, 6})
    with caplog.at_level(logging.WARNING, logger="pydca_tpu_torch.plm"):
        with pytest.raises(RuntimeError, match="injected fault on chunk 5"):
            port_fit(problem, 20, str(tmp_path / "ck.npz"))
    assert len(retry_warnings(caplog)) == 2 and len(calls) == 5


def test_not_implemented_is_never_retried(tmp_path, monkeypatch, caplog, problem):
    failing_steps(monkeypatch, None, {3}, exc=NotImplementedError)
    with caplog.at_level(logging.WARNING, logger="pydca_tpu_torch.plm"):
        with pytest.raises(NotImplementedError):
            port_fit(problem, 20, str(tmp_path / "ck.npz"))
    assert not retry_warnings(caplog)


W2_ROUTES = pytest.mark.parametrize("seq_block", [None, BLOCK], ids=["full", "streamed"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_w2_cross_package_resume(tmp_path, problem, writer):
    """A w2-space file (generic, ``L*q + (L*q)^2`` parameters) written at
    k = 5 by either package, resumed by both to k = 10 in the w2 space; the
    results in the compact layout."""
    path = str(tmp_path / "w2.npz")
    (jax_fit if writer == "jax" else port_fit)(problem, 5, path, param_space="w2")
    with np.load(path) as f:
        assert f["x"].shape == (L * Q + (L * Q) ** 2,) and "zzt" not in f.files
    rj, rt = resume_both(tmp_path, problem, path, None, param_space="w2")
    assert rt.num_iters == int(rj.num_iters) == 10
    assert rt.x.shape == (L * Q + L * (L - 1) // 2 * Q * Q,)
    np.testing.assert_allclose(rt.fx, float(rj.fx), rtol=1e-4)
    assert rel_l2(rt.x.numpy(), np.asarray(rj.x)) <= 1e-3


@W2_ROUTES
def test_w2_interrupted_resume_is_bitwise(tmp_path, problem, seq_block):
    full = port_fit(problem, 20, seq_block=seq_block, param_space="w2")
    ckpt = str(tmp_path / "w2")
    part = port_fit(problem, 10, ckpt, seq_block, param_space="w2")
    assert part.num_iters == 10
    resumed = port_fit(problem, 20, ckpt, seq_block, param_space="w2")
    assert resumed.num_iters == full.num_iters == 20
    assert torch.equal(resumed.x, full.x)
    assert resumed.fx == full.fx and resumed.n_evals == full.n_evals


@pytest.mark.parametrize("written,asked", [("compact", "w2"), ("w2", "compact")])
def test_checkpoint_space_wins_on_resume(tmp_path, problem, caplog, written, asked):
    """A file in the other parameter space continues in its own space in
    both packages (``pydca_tpu/plm.py:1284-1294``; a fused compact file
    under a w2 request goes through ``_generic_from_fused`` and back to the
    fused loop): the same iterations and optimum."""
    path = str(tmp_path / "k5.npz")
    jax_fit(problem, 5, path, param_space=written)
    with caplog.at_level(logging.INFO, logger="pydca_tpu_torch.plm"):
        rj, rt = resume_both(tmp_path, problem, path, None, param_space=asked)
    assert f"checkpoint is in {written} space; continuing in that space" in caplog.text
    assert rt.num_iters == int(rj.num_iters) == 10
    np.testing.assert_allclose(rt.fx, float(rj.fx), rtol=1e-4)
    assert rel_l2(rt.x.numpy(), np.asarray(rj.x)) <= 1e-3


def test_checkpoint_of_another_shape_raises(tmp_path, problem):
    """A file whose parameter count fits neither layout of this (L, q)."""
    st = port_state(problem, BLOCK, steps=1)
    d = st.x.shape[0] + 1
    path = str(tmp_path / "odd.npz")
    tplm._save_state(path, LBFGSState(
        x=torch.zeros(d), f=st.f, g=torch.zeros(d), z=torch.zeros(2 * M, d), rho=st.rho,
        k=st.k, done=False, converged=False, ls_failed=False, n_evals=st.n_evals))
    for seq_block in (None, BLOCK):
        with pytest.raises(ValueError, match=f"holds {d} parameters"):
            port_fit(problem, 10, path, seq_block)


def test_bf16_history_file_loads(tmp_path, caplog, problem):
    """A fused file with bfloat16 history rows, as the TPU writes it (the
    JAX fit with ``hist_bf16=True``): the rows load exactly and stay
    bfloat16, both packages go on from it in bfloat16 for five iterations
    and agree at the cross-package tolerance (f rtol 1e-4, theta relative
    L2 <= 1e-3), and the port's next file says ``z_bf16 = True``."""
    msa, w, lam = problem
    path = str(tmp_path / "bf16.npz")
    jplm.fit_plm(jnp.asarray(msa), jnp.asarray(w), jnp.float32(lam), jnp.float32(lam), L, Q,
                 max_iterations=5, chunk_size=5, checkpoint_path=path, checkpoint_every=5,
                 hist_bf16=True)
    with np.load(path) as f:
        assert bool(f["z_bf16"])
        rows = f["z"]
    assert np.array_equal(rows, np.asarray(jnp.asarray(rows).astype(jnp.bfloat16), np.float32))
    with caplog.at_level(logging.INFO, logger="pydca_tpu_torch.plm"):
        st = tplm._load_state(path, "cpu")
    assert "bfloat16 history rows" in caplog.text
    assert st.z.dtype == torch.bfloat16 and np.array_equal(st.z.float().numpy(), rows)
    rj, rt = resume_both(tmp_path, problem, path, None)
    assert rt.num_iters == int(rj.num_iters) == 10
    np.testing.assert_allclose(rt.fx, float(rj.fx), rtol=1e-4)
    assert rel_l2(rt.x.numpy(), np.asarray(rj.x)) <= 1e-3
    for name in ("rt.npz", "rj.npz"):  # both next files keep bfloat16 rows
        with np.load(str(tmp_path / name)) as f:
            assert int(f["k"]) == 10 and bool(f["z_bf16"])
            rows = f["z"]
        assert np.array_equal(rows, np.asarray(jnp.asarray(rows).astype(jnp.bfloat16),
                                               np.float32))


def test_missing_generic_field_raises(tmp_path, problem):
    path = str(tmp_path / "bad.npz")
    tplm._save_state(path, port_state(problem, BLOCK, steps=1))
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files if k != "rho"}
    np.savez(path, **arrays)
    with pytest.raises(KeyError, match="rho"):
        tplm._load_state(path, "cpu")


@pytest.mark.parametrize("argv", [
    ["compute_fn", "--apc"],
    ["compute_di"],
    ["compute_params"],
    ["compute_fn", "--seq_block", "16"],
])
def test_cli_checkpoint_resumes_a_finished_run(tmp_path, argv):
    """``--checkpoint`` through the port's CLI (``tests/test_cli.py:91-115``):
    a second run from the finished file takes 0 more iterations and writes
    the same files.  The JAX CLI resumes the port's file the same way."""
    codes, _ = planted_family(60, 12, 5, seed=4, n_pairs=2, n_ancestors=6)
    fa = str(tmp_path / "tiny.fa")
    write_family_fasta(fa, codes, talph.RNA)
    ckpt = str(tmp_path / "ck" / "state.npz")
    outs = [str(tmp_path / f"out{k}") for k in range(3)]

    def run(out):
        return tcli.run_plm_dca([argv[0], "rna", fa, "--device", "cpu", "--output_dir", out,
                                 "--max_iterations", "30", "--checkpoint", ckpt] + argv[1:])

    first = run(outs[0])
    assert os.path.exists(ckpt)
    stamp = os.stat(ckpt).st_mtime_ns
    second = run(outs[1])
    assert second.fit_result.num_iters == first.fit_result.num_iters
    assert second.fit_result.n_evals == first.fit_result.n_evals
    assert torch.equal(second.fit_result.x, first.fit_result.x)
    assert os.stat(ckpt).st_mtime_ns == stamp  # nothing ran, nothing saved
    names = sorted(os.listdir(outs[0]))
    assert names == sorted(os.listdir(outs[1]))
    for name in names:
        with open(os.path.join(outs[0], name)) as a, open(os.path.join(outs[1], name)) as b:
            assert a.read() == b.read()
    args = vars(jcli.build_parser().parse_args([argv[0], "rna", fa, "--max_iterations", "30",
                                                "--checkpoint", ckpt] + argv[1:]))
    for key in ("mesh", "output_dir", "param_space"):
        args.pop(key)
    jcli.execute_from_command_line(output_dir=outs[2], mesh=None, **args)
    assert sorted(os.listdir(outs[2])) == names
    assert os.stat(ckpt).st_mtime_ns == stamp
