"""CUDA kernels of the port against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA card (a CUDA kernel has no
CPU mode; the CPU tests hold the plain versions against the JAX package).
Imports only torch and the port, so it runs where JAX is not installed
(``--noconftest`` skips ``tests/conftest.py``, which imports JAX):

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from pydca_tpu_torch import stats
from pydca_tpu_torch.device import set_precision
from pydca_tpu_torch.meanfield import MeanFieldDCA
from pydca_tpu_torch.ops import cuda_kernels as ck
from pydca_tpu_torch.synthetic import planted_family, spearman, top_k_overlap


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    set_precision()
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,l,q", [(1, 3, 5), (65, 64, 5), (1000, 97, 21), (2704, 102, 5)])
def test_identity_counts_kernel_equals_plain(cuda, n, l, q):
    codes = torch.tensor(planted_family(n, l, q, seed=n, n_pairs=0)[0], device=cuda)
    valid = torch.tensor(np.random.default_rng(n).random(n) > 0.2, device=cuda)
    for v in (None, valid):
        before = ck.identity_counts.launches
        got = ck.identity_counts(codes, 0.8 * l, q, valid=v)
        want = ck.identity_counts_reference(codes, 0.8 * l, q, valid=v)
        torch.cuda.synchronize()
        assert torch.equal(got, want)  # integer counts: exact
        assert ck.identity_counts.launches == before + 1


@pytest.mark.gpu
def test_sequence_weights_cuda_equal_cpu(cuda):
    codes = torch.tensor(planted_family(2000, 60, 21, seed=3, n_pairs=0)[0])
    w_cpu = stats.sequence_weights(codes, 0.8, 21)
    w_gpu = stats.sequence_weights(codes.to(cuda), 0.8, 21)
    assert torch.equal(w_cpu, w_gpu.cpu())


@pytest.mark.gpu
def test_out_of_range_codes_raise_on_card(cuda):
    codes = torch.full((8, 5), 5, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        ck.identity_counts(codes, 4.0, 5)


GRAM_CASES = [
    (1, 3, 5, torch.float32),  # N = 1
    (30, 26, 5, torch.float32),  # N smaller than one 64-sequence stage
    (130, 26, 5, torch.float32),  # K = 130: one full tile and a ragged one
    (2000, 26, 5, torch.float32),  # K = 130 with split-N
    (1000, 97, 21, torch.float32),
    (2704, 102, 5, torch.float32),  # RF00167 shape, split-N
    (300, 61, 21, torch.float64),  # float64, split-N
    (2704, 102, 5, torch.float64),  # float64, split-N over 11 chunks
]
SPLIT_CASES = [GRAM_CASES[i] for i in (3, 5, 6, 7)]  # the cases marked split-N


@pytest.mark.gpu
@pytest.mark.parametrize("n,l,q,dtype", GRAM_CASES)
def test_weighted_gram_kernel_equals_plain(cuda, n, l, q, dtype):
    codes = torch.tensor(planted_family(n, l, q, seed=n, n_pairs=0)[0], device=cuda)
    w = torch.tensor(np.random.default_rng(n).uniform(0.05, 1.0, n), dtype=dtype, device=cuda)
    before = ck.weighted_gram.launches
    got = ck.weighted_gram(codes, w, q)
    want = ck.weighted_gram_reference(codes, w, q)
    torch.cuda.synchronize()
    assert ck.weighted_gram.launches == before + 1
    assert got.dtype == dtype and got.shape == (l * q, l * q)
    # no atomics, sums in a fixed order: the same bits in every run
    assert torch.equal(got, ck.weighted_gram(codes, w, q))
    # sums of non-negative terms: zero exactly where there are no terms
    assert torch.equal(got == 0, want == 0)
    assert torch.equal(got, got.T)
    meff = w.sum()
    rtol, atol = (1e-5, 1e-6) if dtype == torch.float32 else (1e-12, 1e-15)
    torch.testing.assert_close(got / meff, want / meff, rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("n,l,q", [(2704, 102, 5), (2030, 195, 21)])
def test_weighted_gram_f32_close_to_float64(cuda, n, l, q):
    # exact fp32 from three bf16 pieces: ~4e-7 of float64 on the same
    # weights, as cuBLAS fp32; two pieces alone give ~7e-6
    codes = torch.tensor(planted_family(n, l, q, seed=n + l, n_pairs=0)[0], device=cuda)
    w = torch.tensor(np.random.default_rng(n).uniform(0.05, 1.0, n), dtype=torch.float32,
                     device=cuda)
    got = ck.weighted_gram(codes, w, q).double()
    want = ck.weighted_gram_reference(codes, w.double(), q)
    nz = want != 0
    assert float(((got - want).abs()[nz] / want[nz]).max()) <= 2e-6


@pytest.mark.gpu
@pytest.mark.parametrize("n,l,q,dtype", SPLIT_CASES)
def test_weighted_gram_split_n_is_active(cuda, n, l, q, dtype):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert ck._gram_plan(n, l * q, sms, itemsize)[0] > 1


@pytest.mark.gpu
def test_weighted_gram_out_of_range_codes_raise_on_card(cuda):
    codes = torch.full((8, 5), 5, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        ck.weighted_gram(codes, torch.ones(8, device=cuda), 5)


@pytest.mark.gpu
def test_weighted_gram_wide_codes_out_of_range_raise_on_card(cuda):
    # 261 would wrap to a valid int8 code: checked before the cast
    codes = torch.full((8, 5), 261, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ck.weighted_gram(codes, torch.ones(8, device=cuda), 5)


@pytest.mark.gpu
def test_meanfield_cuda_equals_cpu(cuda):
    codes = planted_family(1500, 80, 21, seed=4, n_pairs=8)[0]
    runs = {}
    for device in ("cpu", "cuda"):
        inst = MeanFieldDCA(codes, "protein", device=device)
        runs[device] = (inst.get_sequences_weight().cpu(), inst.compute_sorted_FN_APC())
    assert torch.equal(runs["cpu"][0], runs["cuda"][0])
    assert spearman(runs["cpu"][1], runs["cuda"][1], 80) >= 0.98
    assert top_k_overlap(runs["cpu"][1], runs["cuda"][1], 20) >= 0.9
