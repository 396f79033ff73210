"""Where the port's plmDCA engine decides whether its fit streams.

``PlmDCA`` streams the fit's loss past ``STREAMING_LOGITS_BYTES`` of float32
logits on the rows one card holds (``plm.fit_seq_block``): N on one device,
a rank's stripe ``ceil(N / K)`` on a K-rank data mesh.  The whole-alignment
statistics it computes on its own device (``fi``) keep the block of the
global N (``plm.streaming_block``).  A rank's place in the mesh is a
``DataMesh`` built by hand here: deciding the route takes no collective.
The fused route on two real ranks, against the plain float64 reference, is
``test_torch_mesh_stream.py``'s.
"""

import logging

import numpy as np
import pytest
import torch

from pydca_tpu_torch import alphabets as talph
from pydca_tpu_torch import plm as tplm
from pydca_tpu_torch import stats as tstats
from pydca_tpu_torch.io.fasta import MSA
from pydca_tpu_torch.parallel.mesh import DataMesh
from pydca_tpu_torch.synthetic import planted_family

L, Q = 100, 21
THRESHOLD_N = (1 << 30) // (4 * L * Q)  # the deepest alignment a card fits fused
BLOCK = max(1024, THRESHOLD_N)  # the block past it


def engine(n, mesh=None, **kw):
    """An engine on a zero alignment of ``n`` rows (nothing is fitted)."""
    data = np.zeros((n, L), np.int8)
    return tplm.PlmDCA(MSA(data=data, alphabet=talph.PROTEIN), "protein", device="cpu",
                       mesh=mesh, **kw)


def rank(r, k):
    """Rank ``r`` of a ``k``-rank data mesh, without a process group."""
    return DataMesh(group=None, rank=r, world_size=k, device=torch.device("cpu"))


@pytest.mark.parametrize("n, want", [(THRESHOLD_N - 1, None), (THRESHOLD_N, None),
                                     (THRESHOLD_N + 1, BLOCK)],
                         ids=["below", "at", "past"])
def test_one_card_decides_on_its_n(n, want):
    eng = engine(n)
    assert eng.fit_block == eng.seq_block == want
    assert tplm.fit_seq_block(n, L, Q) == tplm.streaming_block(n, L, Q) == want


# (N on K ranks, the rows a rank holds): a stripe at the bound, one past it,
# and a padded last stripe on either side
STRIPES = [(k, n, stripe) for k in (2, 3, 4) for n, stripe in (
    (k * THRESHOLD_N, THRESHOLD_N),
    (k * THRESHOLD_N - (k - 1), THRESHOLD_N),
    (k * THRESHOLD_N + 1, THRESHOLD_N + 1),
    (k * (THRESHOLD_N + 1), THRESHOLD_N + 1),
)]


@pytest.mark.parametrize("k, n, stripe", STRIPES,
                         ids=[f"k{k}-n{n}" for k, n, _ in STRIPES])
def test_mesh_decides_on_the_stripe(k, n, stripe):
    want = None if stripe <= THRESHOLD_N else BLOCK
    blocks = set()
    for r in range(k):
        mesh = rank(r, k)
        n_pad, start, stop = mesh.stripe_rows(n)
        assert stop - start == stripe and n_pad >= n
        eng = engine(n, mesh)
        assert eng.seq_block == BLOCK  # the global N streams
        blocks.add(eng.fit_block)
        assert tplm.fit_seq_block(n, L, Q, mesh) == eng.fit_block
    assert blocks == {want}  # every rank takes the same route


@pytest.mark.parametrize("k", [2, 4])
def test_deeper_than_k_bounds_streams(k):
    """Past K x the bound each stripe streams, as on one card."""
    n = 2 * k * THRESHOLD_N
    for r in range(k):
        eng = engine(n, rank(r, k))
        assert eng.fit_block == eng.seq_block == BLOCK


@pytest.mark.parametrize("mesh", [None, rank(0, 2), rank(1, 2)], ids=["one", "rank0", "rank1"])
def test_explicit_seq_block_streams(mesh):
    eng = engine(300, mesh, seq_block=64)
    assert eng.fit_block == eng.seq_block == 64


def test_whole_alignment_freqs_keep_the_global_block(monkeypatch):
    """Under a mesh whose stripes fit fused, ``fi`` on the engine's device
    still streams over the global N's blocks."""
    monkeypatch.setattr(tplm, "STREAMING_LOGITS_BYTES", 4 * 100 * 12 * 21)
    codes = planted_family(200, 12, 21, seed=3, n_pairs=3, n_ancestors=16)[0]
    eng = tplm.PlmDCA(MSA(data=codes, alphabet=talph.PROTEIN), "protein", device="cpu",
                      mesh=rank(0, 2))
    assert eng.fit_block is None and eng.seq_block == 1024
    w = torch.rand(200, generator=torch.Generator().manual_seed(0))
    monkeypatch.setattr(eng, "compute_seqs_weight", lambda: w)
    seen, real = [], tstats.single_site_freqs

    def recorded(msa, weights, q, block=None, mesh=None):
        seen.append((msa.shape[0], block))
        return real(msa, weights, q, block=block, mesh=mesh)

    monkeypatch.setattr(tstats, "single_site_freqs", recorded)
    fi = eng.get_single_site_freqs()
    assert seen == [(200, 1024)]
    want = real(torch.from_numpy(codes), w, 21)
    torch.testing.assert_close(fi, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kw, route", [
    ({}, "fused loop"),
    ({"seq_block": 16}, "generic loop, compact space, streamed over blocks of 16"),
], ids=["fused", "streamed"])
def test_fit_logs_its_route(caplog, kw, route):
    codes = planted_family(60, 10, 5, seed=5, n_pairs=3, n_ancestors=16)[0]
    eng = tplm.PlmDCA(MSA(data=codes, alphabet=talph.RNA), "rna", device="cpu",
                      max_iterations=2, **kw)
    with caplog.at_level(logging.INFO, logger="pydca_tpu_torch.plm"):
        eng.get_fields_and_couplings_from_backend()
    lines = [r.getMessage() for r in caplog.records if "rows a card" in r.getMessage()]
    assert lines == [f"plmDCA fit on 60 rows a card: {route}"]
    assert eng.fit_block == kw.get("seq_block")
