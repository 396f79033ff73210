"""CUDA kernels of the port against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA card (a CUDA kernel has no
CPU mode; the CPU tests hold the plain versions against the JAX package).
Imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from pydca_tpu_torch import stats
from pydca_tpu_torch.ops import cuda_kernels as ck
from pydca_tpu_torch.synthetic import planted_family


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
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
