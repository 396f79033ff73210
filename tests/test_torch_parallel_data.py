"""The port's distributed MSA reader against the JAX package's.

``pydca_tpu_torch.parallel.data`` is a copy of ``pydca_tpu.parallel.data``
with torch in place of JAX.  Here 1, 2 and 3 processes are simulated with
threads that pool their arrays through a barrier (the ``allgather_fn``
override both packages take), over a striped single file and over shard
files; every process's fields must equal the JAX reader's exactly.  The
real gloo transport runs in the 2-process workers of
``tests/test_torch_parallel_fit.py``.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from pydca_tpu.parallel import data as jdata
from pydca_tpu_torch import stats as tstats
from pydca_tpu_torch.parallel import data as tdata
from pydca_tpu_torch.parallel import make_mesh


def _write_fasta(path, rows, letters="ACGU-", start=0):
    with open(path, "w") as fh:
        for k, r in enumerate(rows):
            fh.write(f">s{start + k}\n" + "".join(letters[int(x)] for x in r) + "\n")


@pytest.fixture()
def rows():
    rng = np.random.default_rng(11)
    base = rng.integers(0, 5, size=(6, 20))
    rows = base[rng.integers(0, 6, size=121)]  # many duplicates; N odd
    mut = rng.random(rows.shape) < 0.1
    return np.where(mut, rng.integers(0, 5, size=rows.shape), rows)


def _files(tmp_path, rows, layout, n_files=5):
    if layout == "striped":
        path = str(tmp_path / "whole.fa")
        _write_fasta(path, rows)
        return path
    files = []
    for k, idx in enumerate(np.array_split(np.arange(len(rows)), n_files)):
        f = str(tmp_path / f"shard{k}.fa")
        _write_fasta(f, rows[idx], start=int(idx[0]))
        files.append(f)
    return files


class _ThreadedAllgather:
    """Pools one array from each of ``nproc`` threads (the contract of a
    real all-gather: every process gets every process's array)."""

    def __init__(self, nproc):
        self.barrier = threading.Barrier(nproc)
        self.slots = [None] * nproc

    def for_process(self, pid):
        def allgather(local):
            self.slots[pid] = local
            self.barrier.wait()
            out = list(self.slots)
            self.barrier.wait()
            return out

        return allgather


def _read_threads(reader, files, nproc, **kwargs):
    ag = _ThreadedAllgather(nproc)
    with ThreadPoolExecutor(nproc) as ex:
        futs = [ex.submit(reader, files, "rna", process_id=p, num_processes=nproc,
                          allgather_fn=ag.for_process(p), **kwargs) for p in range(nproc)]
        return [f.result(timeout=60) for f in futs]


def _assert_same_shard(got, want):
    np.testing.assert_array_equal(got.local_data, want.local_data)
    assert got.local_data.dtype == want.local_data.dtype
    np.testing.assert_array_equal(got.local_valid, want.local_valid)
    assert got.ids == want.ids
    assert got.q == want.q
    assert got.global_num_seqs == want.global_num_seqs
    assert got.seqs_len == want.seqs_len
    assert got.num_processes == want.num_processes


@pytest.mark.parametrize("layout", ["striped", "shards"])
@pytest.mark.parametrize("nproc", [1, 2, 3])
def test_read_msa_distributed_matches_jax(tmp_path, rows, layout, nproc):
    files = _files(tmp_path, rows, layout)
    got = _read_threads(tdata.read_msa_distributed, files, nproc)
    want = _read_threads(jdata.read_msa_distributed, files, nproc)
    for g, w in zip(got, want):
        _assert_same_shard(g, w)


@pytest.mark.parametrize("layout", ["striped", "shards"])
@pytest.mark.parametrize("nproc", [2, 3])
def test_dedup_keep_masks_match_jax(tmp_path, rows, layout, nproc):
    """Hashes, global indices and the first-occurrence keep mask of every
    simulated process, exactly."""
    files = _files(tmp_path, rows, layout)
    t_shards = [tdata.load_local_shard(files, "rna", p, nproc) for p in range(nproc)]
    j_shards = [jdata.load_local_shard(files, "rna", p, nproc) for p in range(nproc)]
    t_h = [tdata._row_hashes(s.data) for s in t_shards]
    j_h = [jdata._row_hashes(s.data) for s in j_shards]
    all_h = np.concatenate(j_h)
    all_i = np.concatenate([s.global_index for s in j_shards])
    for ts, js, th, jh in zip(t_shards, j_shards, t_h, j_h):
        np.testing.assert_array_equal(ts.data, js.data)
        np.testing.assert_array_equal(ts.global_index, js.global_index)
        np.testing.assert_array_equal(th, jh)
        keep_t = tdata.global_dedup_keep(th, ts.global_index, all_h, all_i)
        keep_j = jdata.global_dedup_keep(jh, js.global_index, all_h, all_i)
        np.testing.assert_array_equal(keep_t, keep_j)
        assert keep_t.dtype == bool


def test_zero_row_processes_match_jax(tmp_path, rows):
    """2 shard files over 4 processes: processes 2 and 3 own no file, pad
    to (n_pad, L) and still take part in every gather."""
    files = _files(tmp_path, rows, "shards", n_files=2)
    got = _read_threads(tdata.read_msa_distributed, files, 4)
    want = _read_threads(jdata.read_msa_distributed, files, 4)
    for g, w in zip(got, want):
        _assert_same_shard(g, w)
    assert not got[2].local_valid.any() and not got[3].local_valid.any()
    assert got[2].local_data.shape == (got[0].local_data.shape[0], rows.shape[1])


def test_file_counts_match_jax(tmp_path):
    """A manifest of per-file record counts is honoured and checked while
    parsing, as in the JAX package."""
    rows = (np.arange(24).reshape(8, 3) % 5).astype(np.int8)
    files = []
    for k in range(4):
        f = str(tmp_path / f"m{k}.fa")
        _write_fasta(f, rows[2 * k : 2 * k + 2], start=2 * k)
        files.append(f)
    got = tdata.load_local_shard(files, "rna", 1, 2, file_counts=[2, 2, 2, 2])
    want = jdata.load_local_shard(files, "rna", 1, 2, file_counts=[2, 2, 2, 2])
    np.testing.assert_array_equal(got.global_index, want.global_index)
    np.testing.assert_array_equal(got.data, want.data)
    for bad in ([2, 3, 2, 2], [2, 2]):
        with pytest.raises(ValueError):
            tdata.load_local_shard(files, "rna", 1, 2, file_counts=bad)
    sharded = _read_threads(tdata.read_msa_distributed, files, 2, file_counts=[2, 2, 2, 2])
    expect = _read_threads(jdata.read_msa_distributed, files, 2, file_counts=[2, 2, 2, 2])
    for g, w in zip(sharded, expect):
        _assert_same_shard(g, w)


def test_simulation_without_allgather_raises(tmp_path, rows):
    """Two processes in a runtime without a process group and without
    ``allgather_fn``: the documented error, as in the JAX package."""
    path = _files(tmp_path, rows, "striped")
    with pytest.raises(RuntimeError, match="allgather_fn"):
        tdata.read_msa_distributed(path, "rna", process_id=0, num_processes=2)


def test_local_tensors_and_weights_on_one_process(tmp_path, rows):
    """One process: the stripe is every row, on the mesh's device, and the
    weights are the one-device weights; a mesh of another size raises."""
    path = _files(tmp_path, rows, "striped")
    sharded = tdata.read_msa_distributed(path, "rna")
    mesh = make_mesh(device="cpu")
    codes, valid = sharded.local_tensors(mesh)
    assert codes.dtype == torch.int8 and valid.dtype == torch.bool
    np.testing.assert_array_equal(codes.numpy(), sharded.local_data)
    codes_w, w, valid_w = tdata.weights_distributed(sharded, 0.8, mesh)
    want = tstats.sequence_weights(codes, 0.8, sharded.q)
    assert torch.equal(w, want) and torch.equal(codes_w, codes) and bool(valid_w.all())
    sharded.num_processes = 2
    with pytest.raises(ValueError, match="2 processes"):
        sharded.local_tensors(mesh)
