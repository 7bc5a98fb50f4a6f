"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode). The file imports no JAX, so it runs where only PyTorch
is installed; ``tests/conftest.py`` imports JAX, hence ``--noconftest``:

    python -m pytest tests/test_torch_port_kernels.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from vision_transformers_tpu_torch.ops import attention as tattn
from vision_transformers_tpu_torch.ops import flash_attention as tfa


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# fp32: summation order only. bf16: the plain version rounds the
# unnormalised probabilities to bf16 before PV (as the TPU kernel does) and
# the kernel keeps them fp32, plus one rounding of the output.
_KERNEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,heads,dh,kv_valid", [
    (2, 197, 12, 64, None), (2, 208, 12, 64, 197), (3, 49, 3, 32, None),
    (1, 33, 2, 16, 30)])
def test_packed_kernel_matches_plain(cuda, dtype, b, s, heads, dh, kv_valid):
    qkv = torch.from_numpy(_randn(22, b, s, 3 * heads * dh)).to(cuda, dtype)
    out, lse = tfa.packed_flash_attention_fwd(qkv, heads, kv_valid=kv_valid)
    ref, ref_lse = tfa.packed_flash_attention_reference(qkv, heads,
                                                        kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= _KERNEL_TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_lead", [None, 1, 2, 4])
@pytest.mark.parametrize("sq,sk,kv_valid", [(49, 49, None), (100, 25, None),
                                            (70, 70, 60)])
def test_flash_kernel_matches_plain(cuda, dtype, bias_lead, sq, sk, kv_valid):
    b, h, d = 4, 3, 32
    q = torch.from_numpy(_randn(23, b, h, sq, d)).to(cuda, dtype)
    k = torch.from_numpy(_randn(24, b, h, sk, d)).to(cuda, dtype)
    v = torch.from_numpy(_randn(25, b, h, sk, d)).to(cuda, dtype)
    bias = None if bias_lead is None else \
        torch.from_numpy(_randn(26, bias_lead, h, sq, sk)).to(cuda)
    out, lse = tfa.flash_attention_fwd(q, k, v, bias, kv_valid=kv_valid)
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, bias,
                                                 kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= _KERNEL_TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_unported_paths_raise_on_cuda(cuda):
    q = torch.zeros(1, 2, 8, 16, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tattn.dot_product_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tattn.dot_product_attention(
            q, q, q, mask=torch.ones(1, 1, 1, 8, dtype=torch.bool, device=cuda))
    big = torch.zeros(1, 1, 1300, 16, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfa.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="head dim"):
        tfa.packed_flash_attention(torch.zeros(1, 4, 3 * 2 * 8, device=cuda), 2)
