"""Multi-process data loading: host-local FASTA shards -> one stripe of rows
per rank.

Port of ``pydca_tpu/parallel/data.py`` for ``torch.distributed``.  The
reference loads the whole MSA in-process (it has no distributed mode);
:func:`pydca_tpu_torch.io.fasta.read_msa` likewise reads the full file in
every process.  At 100k+-sequence scale that wastes host RAM and ingest
time P-fold, so each process takes its own slice of the data:

1. **Shard loading** -- either a list of FASTA shard files (process ``p``
   of ``P`` opens only ``files[p::P]``; true host-local IO) or a single
   file (every process parses the text -- IO is cheap -- but *encodes and
   retains* only its round-robin stripe, bounding host memory at N/P
   rows).
2. **Global dedup** -- the reference drops duplicate sequences after
   encoding, keeping the first occurrence in file order
   (``fasta_reader.py:153``).  Done here without gathering sequence data:
   each row is hashed (blake2b, 128 bits -- collision probability ~1e-21
   at N=1e9, the JAX package's trade-off), hashes and global file-order
   indices are all-gathered (16 bytes/row, not L bytes), and every process
   keeps its rows whose index is the global minimum for that hash.
3. **Local tensors** -- the local rows pad to a common per-process count,
   with a ``valid`` mask marking the pads; :meth:`ShardedMSA.local_tensors`
   puts this rank's rows on its device (torch has no global array: the
   rank's stripe is what the sharded fits take).  Every downstream
   statistic is a weighted sum over sequences, so pad rows are inert once
   their weight is zero, and :func:`pydca_tpu_torch.stats.sequence_weights`
   takes ``valid`` so pads never count as neighbours either.

The default transport is an all-gather over a gloo group of the CPU (the
default group when its backend is gloo, else a gloo group made once);
``allgather_fn`` overrides it, e.g. to pool simulated processes.  With one
process this degrades to an ordinary read (stripe = everything).
"""

from __future__ import annotations

import hashlib
import logging
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..alphabets import get_alphabet
from ..io.fasta import parse_fasta
from .mesh import DataMesh

logger = logging.getLogger(__name__)

__all__ = [
    "LocalShard",
    "ShardedMSA",
    "load_local_shard",
    "global_dedup_keep",
    "read_msa_distributed",
    "weights_distributed",
]


@dataclass
class LocalShard:
    """This process's rows: encoded data + global file-order index per row."""

    data: np.ndarray  # (n_local, L) int8
    ids: List[str]
    global_index: np.ndarray  # (n_local,) int64, position in global file order
    seqs_len: int = 0  # L; known even when this process owns zero rows
                       # (0 only if it could not be determined locally)


@dataclass
class ShardedMSA:
    """Deduplicated, process-local view of a distributed MSA."""

    local_data: np.ndarray  # (n_pad, L) int8, pad rows = gap state
    local_valid: np.ndarray  # (n_pad,) bool
    ids: List[str]
    q: int
    global_num_seqs: int  # total rows after dedup, across all processes
    seqs_len: int
    num_processes: int

    def local_tensors(self, mesh: DataMesh) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's ``(n_pad, L)`` int8 codes and ``(n_pad,)`` bool valid
        mask on the mesh's device (the stripe the sharded fits take).  Call
        with a mesh of one rank per process."""
        if mesh.world_size != self.num_processes:
            raise ValueError(
                f"the mesh has {mesh.world_size} ranks; the data was read by "
                f"{self.num_processes} processes"
            )
        data = torch.from_numpy(np.ascontiguousarray(self.local_data, dtype=np.int8))
        valid = torch.from_numpy(np.ascontiguousarray(self.local_valid))
        return data.to(mesh.device), valid.to(mesh.device)


def _row_hashes(data: np.ndarray) -> np.ndarray:
    """(n, 2) uint64 blake2b-128 hash per row."""
    out = np.empty((data.shape[0], 2), dtype=np.uint64)
    row_bytes = np.ascontiguousarray(data, dtype=np.int8)
    for k in range(data.shape[0]):
        d = hashlib.blake2b(row_bytes[k].tobytes(), digest_size=16).digest()
        out[k] = np.frombuffer(d, dtype=np.uint64)
    return out


def _peek_seq_len(path: str) -> int:
    """Length of the first record in a FASTA file (wrapped lines joined);
    0 if the file is unreadable or empty."""
    try:
        parts: List[str] = []
        with open(path) as fh:
            started = False
            for line in fh:
                line = line.strip()
                if line.startswith(">"):
                    if started:
                        break
                    started = True
                elif started:
                    parts.append(line)
        return len("".join(parts))
    except OSError:
        return 0


def load_local_shard(
    files: Union[str, Sequence[str]],
    biomolecule: str,
    process_id: int,
    num_processes: int,
    *,
    file_counts: Optional[Sequence[int]] = None,
) -> LocalShard:
    """Parse and encode only this process's slice of the input.

    ``files`` as a list: shard files are assigned round-robin
    (``files[process_id::num_processes]``) and each process opens only its
    own for loading — the global order is (file index, record index).
    Without ``file_counts``, every process additionally opens *all* shard
    files once to count ``>`` headers (O(total corpus bytes) per host);
    pass precomputed per-file record counts (e.g. from a manifest, or
    all-gathered — :func:`read_msa_distributed` does the latter) to keep
    IO strictly host-local.  ``files`` as a single path: every process
    parses the text but encodes/retains only records ``r`` with
    ``r % num_processes == process_id``.

    A process owning zero rows still reports ``seqs_len`` when it can
    determine L locally (first record of the first shard file); in a true
    multi-host layout where that file is absent, ``seqs_len`` is 0 and
    :func:`read_msa_distributed` recovers it with an all-gather.
    """
    alphabet = get_alphabet(biomolecule)
    ids: List[str] = []
    seqs: List[str] = []
    gidx: List[int] = []
    seqs_len = 0

    if isinstance(files, str):
        with open(files) as fh:
            all_ids, all_seqs = parse_fasta(fh.read())
        if all_seqs:
            seqs_len = len(all_seqs[0])
        for r in range(process_id, len(all_seqs), num_processes):
            ids.append(all_ids[r])
            seqs.append(all_seqs[r])
            gidx.append(r)
    else:
        files = list(files)
        # global record order: file-major — per-file record counts make
        # indices consistent across processes without communication
        if file_counts is None:
            counts = []
            for f in files:
                with open(f) as fh:
                    counts.append(sum(1 for line in fh if line.startswith(">")))
        else:
            counts = [int(c) for c in file_counts]
            if len(counts) != len(files):
                raise ValueError(
                    f"file_counts has {len(counts)} entries for "
                    f"{len(files)} files"
                )
        offsets = np.concatenate([[0], np.cumsum(counts)])
        for fi in range(process_id, len(files), num_processes):
            with open(files[fi]) as fh:
                f_ids, f_seqs = parse_fasta(fh.read())
            if len(f_seqs) != counts[fi]:
                raise ValueError(
                    f"{files[fi]}: {len(f_seqs)} records parsed but "
                    f"{counts[fi]} headers counted"
                )
            ids.extend(f_ids)
            seqs.extend(f_seqs)
            gidx.extend(range(offsets[fi], offsets[fi] + counts[fi]))
        if not seqs and files:
            seqs_len = _peek_seq_len(files[0])

    if seqs:
        lengths = {len(s) for s in seqs}
        if len(lengths) != 1:
            raise ValueError(f"inconsistent sequence lengths {sorted(lengths)}")
        seqs_len = lengths.pop()
        data = alphabet.encode_many(seqs)
    else:  # a process may own zero shards: shape (0, L) so padding works
        data = np.zeros((0, seqs_len), dtype=np.int8)
    return LocalShard(
        data=data,
        ids=ids,
        global_index=np.asarray(gidx, dtype=np.int64),
        seqs_len=seqs_len,
    )


def global_dedup_keep(
    local_hashes: np.ndarray,
    local_index: np.ndarray,
    all_hashes: np.ndarray,
    all_index: np.ndarray,
) -> np.ndarray:
    """Keep mask for this process's rows under global first-occurrence dedup.

    A row survives iff its global file-order index is the minimum among all
    rows (on any process) with the same 128-bit hash — exactly the
    reference's keep-first-in-file-order semantics (``fasta_reader.py:153``)
    evaluated distributively.
    """
    first: dict = {}
    for h, idx in zip(map(tuple, all_hashes.tolist()), all_index.tolist()):
        prev = first.get(h)
        if prev is None or idx < prev:
            first[h] = idx
    return np.array(
        [
            first[tuple(h)] == idx
            for h, idx in zip(local_hashes.tolist(), local_index.tolist())
        ],
        dtype=bool,
    )


def _gloo_allgather(local: np.ndarray, group) -> List[np.ndarray]:
    """All-gather one per-process array over the gloo ``group``.

    The rows travel as bytes (int64 hashes and indices need no narrowing):
    the row counts are gathered first, each process pads its rows to the
    largest count, and every process cuts the others' rows back out.
    """
    nproc = dist.get_world_size(group)
    arr = np.ascontiguousarray(local)
    trail = arr.shape[1:]
    rows = arr.reshape(arr.shape[0], int(np.prod(trail, dtype=np.int64))).view(np.uint8)
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(nproc)]
    dist.all_gather(counts, torch.tensor([rows.shape[0]], dtype=torch.int64), group=group)
    counts = [int(c) for c in counts]
    padded = np.zeros((max(counts), rows.shape[1]), np.uint8)
    padded[: rows.shape[0]] = rows
    parts = [torch.empty(padded.shape, dtype=torch.uint8) for _ in range(nproc)]
    dist.all_gather(parts, torch.from_numpy(padded), group=group)
    return [
        np.ascontiguousarray(p.numpy()[:c]).view(arr.dtype).reshape((c,) + trail)
        for p, c in zip(parts, counts)
    ]


def _default_allgather(num_processes: int):
    """The default transport of one read: an all-gather over a gloo group
    of the CPU, the default group when its backend is gloo, else a new one
    (made by every rank at once).  The default group's world size must be
    ``num_processes``."""
    world = _process_topology()[1]
    if world != num_processes:
        raise RuntimeError(
            f"num_processes={num_processes} but the process group has "
            f"{world} process(es); multi-process simulation "
            "in a single-process runtime needs an explicit allgather_fn "
            "(or drive load_local_shard/global_dedup_keep directly)"
        )
    group = dist.group.WORLD if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    return lambda local: _gloo_allgather(local, group)


def _process_topology() -> Tuple[int, int]:
    """``(process id, process count)`` of the default group (0, 1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _allgather_varlen(
    local: np.ndarray, num_processes: int, allgather_fn
) -> List[np.ndarray]:
    """All-gather variable-length per-process arrays through ``allgather_fn``
    (the identity with one process)."""
    if num_processes == 1:
        return [local]
    return allgather_fn(local)


def read_msa_distributed(
    files: Union[str, Sequence[str]],
    biomolecule: str,
    *,
    dedup: bool = True,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
    file_counts: Optional[Sequence[int]] = None,
    allgather_fn=None,
) -> ShardedMSA:
    """Host-local distributed MSA ingestion (see module docstring).

    ``process_id``/``num_processes`` default to the default process
    group's rank and world size (0 and 1 without one).  With
    ``num_processes > 1`` the cross-process gathers run over a gloo group
    of that topology; to *simulate* a multi-process layout in a
    single-process runtime, pass ``allgather_fn`` (a callable pooling each
    simulated process's array) — or drive :func:`load_local_shard` /
    :func:`global_dedup_keep` directly, as the unit tests do.

    ``file_counts``: precomputed per-file record counts (manifest).  When
    absent and ``files`` is a list, each process counts only the files it
    owns and the counts are all-gathered (16 bytes/file), keeping ingest IO
    strictly host-local.
    """
    topo_pid, topo_nproc = _process_topology()
    pid = topo_pid if process_id is None else int(process_id)
    nproc = topo_nproc if num_processes is None else int(num_processes)
    alphabet = get_alphabet(biomolecule)
    if nproc > 1 and allgather_fn is None:
        allgather_fn = _default_allgather(nproc)

    if (
        file_counts is None
        and nproc > 1
        and not isinstance(files, str)
    ):
        # count only owned files; all-gather (file_index, count) pairs
        files = list(files)
        owned_idx = list(range(pid, len(files), nproc))
        pairs = np.zeros((len(owned_idx), 2), dtype=np.int64)
        for row, fi in enumerate(owned_idx):
            with open(files[fi]) as fh:
                pairs[row] = (fi, sum(1 for ln in fh if ln.startswith(">")))
        all_pairs = np.concatenate(
            _allgather_varlen(pairs, nproc, allgather_fn), axis=0
        )
        counts_full = np.zeros(len(files), dtype=np.int64)
        counts_full[all_pairs[:, 0]] = all_pairs[:, 1]
        file_counts = counts_full

    shard = load_local_shard(
        files, biomolecule, pid, nproc, file_counts=file_counts
    )
    keep = np.ones(shard.data.shape[0], dtype=bool)
    if dedup:
        # NB: with nproc > 1 even a zero-row process must join the gathers
        # (they are collectives — skipping them would desynchronize ranks)
        hashes = _row_hashes(shard.data)
        if nproc == 1:
            if shard.data.size:
                keep = global_dedup_keep(
                    hashes, shard.global_index, hashes, shard.global_index
                )
        else:
            h_parts = _allgather_varlen(hashes, nproc, allgather_fn)
            i_parts = _allgather_varlen(
                shard.global_index.reshape(-1, 1), nproc, allgather_fn
            )
            all_h = np.concatenate(h_parts, axis=0)
            all_i = np.concatenate([p.reshape(-1) for p in i_parts], axis=0)
            keep = global_dedup_keep(hashes, shard.global_index, all_h, all_i)

    data = shard.data[keep]
    ids = [shard.ids[k] for k in np.nonzero(keep)[0]]
    n_local = data.shape[0]

    # common padded per-process count (max across processes); also agree on
    # L so a zero-row process pads to (n_pad, L), not (n_pad, 0)
    if nproc == 1:
        n_pad, n_global = n_local, n_local
        seqs_len = shard.seqs_len
    else:
        stats_local = np.asarray([[n_local, shard.seqs_len]], dtype=np.int64)
        gathered = np.concatenate(
            _allgather_varlen(stats_local, nproc, allgather_fn), axis=0
        )
        n_pad, n_global = int(gathered[:, 0].max()), int(gathered[:, 0].sum())
        lens = set(int(x) for x in gathered[:, 1] if int(x) > 0)
        if len(lens) > 1:
            raise ValueError(
                f"inconsistent sequence lengths across processes: {sorted(lens)}"
            )
        seqs_len = lens.pop() if lens else 0
        if data.shape[1] != seqs_len:
            data = data.reshape(n_local, seqs_len)  # only possible if n_local=0
    pad_rows = np.full((n_pad - n_local, seqs_len), alphabet.gap_state, np.int8)
    local_data = np.concatenate([data, pad_rows], axis=0)
    local_valid = np.zeros(n_pad, dtype=bool)
    local_valid[:n_local] = True
    logger.info(
        "process %d/%d: %d local rows (%d after dedup, %d pad)",
        pid, nproc, shard.data.shape[0], n_local, n_pad - n_local,
    )
    return ShardedMSA(
        local_data=local_data,
        local_valid=local_valid,
        ids=ids,
        q=alphabet.q,
        global_num_seqs=n_global,
        seqs_len=seqs_len,
        num_processes=nproc,
    )


def weights_distributed(
    sharded: ShardedMSA,
    seqid: float,
    mesh: DataMesh,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequence weights of the distributed MSA, sharded as it was read.

    Returns this rank's ``(codes, weights, valid)`` on the mesh's device;
    pad rows get weight 0, so all downstream weighted statistics and the
    plm loss ignore them.  The identity counts run over every rank's rows
    (:func:`pydca_tpu_torch.stats.sequence_weights` with the mesh).
    """
    from .. import stats

    codes, valid = sharded.local_tensors(mesh)
    w = stats.sequence_weights(codes, seqid, sharded.q, valid=valid, mesh=mesh)
    return codes, w, valid
