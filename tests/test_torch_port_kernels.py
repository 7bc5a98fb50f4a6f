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


# Gradients, relative to the largest reference element (they grow with S).
# fp32: summation order and expf against torch.exp. bf16: the plain versions
# round the probabilities and ds to bf16 before their products (as the TPU
# kernels do) and the kernels keep them fp32, plus one rounding of the result.
_GRAD_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}


def _grad_close(got, ref, dtype):
    tol = _GRAD_TOL[dtype] * max(1.0, ref.float().abs().max().item())
    return (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,s,heads,dh,kv_valid", [
    (2, 197, 12, 64, None), (2, 208, 12, 64, 197), (4, 65, 4, 64, None),
    (1, 33, 2, 16, 30)])
def test_packed_dropout_and_backward_match_plain(cuda, dtype, rate, b, s,
                                                 heads, dh, kv_valid):
    qkv = torch.from_numpy(_randn(27, b, s, 3 * heads * dh)).to(cuda, dtype)
    do = torch.from_numpy(_randn(28, b, s, heads * dh)).to(cuda, dtype)
    kw = dict(dropout_rate=rate, seed=1234 + (7 << 40), kv_valid=kv_valid)
    out, lse = tfa.packed_flash_attention_fwd(qkv, heads, **kw)
    ref, ref_lse = tfa.packed_flash_attention_reference(qkv, heads, **kw)
    assert (out.float() - ref.float()).abs().max().item() <= _KERNEL_TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    # both backwards from the same (out, lse), so only the backward differs
    dqkv = tfa.packed_flash_attention_bwd(qkv, do, ref, ref_lse, heads, **kw)
    dref = tfa.packed_flash_attention_bwd_reference(qkv, do, ref, ref_lse,
                                                    heads, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dqkv.float()).all())
    assert _grad_close(dqkv, dref, dtype)
    again = tfa.packed_flash_attention_bwd(qkv, do, ref, ref_lse, heads, **kw)
    assert torch.equal(dqkv, again)  # no atomics: equal from run to run


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("sq,sk,kv_valid,masked", [
    (49, 49, None, False), (100, 25, None, False), (70, 70, 60, True),
    (257, 257, None, True)])
def test_dropout_kernels_match_plain(cuda, dtype, rate, sq, sk, kv_valid,
                                     masked):
    b, h, d = 3, 2, 32
    q = torch.from_numpy(_randn(29, b, h, sq, d)).to(cuda, dtype)
    k = torch.from_numpy(_randn(30, b, h, sk, d)).to(cuda, dtype)
    v = torch.from_numpy(_randn(31, b, h, sk, d)).to(cuda, dtype)
    do = torch.from_numpy(_randn(32, b, h, sq, d)).to(cuda, dtype)
    key_mask = None
    if masked:
        m = np.random.RandomState(33).rand(b, sk) > 0.3
        m[:, 0] = True
        key_mask = torch.from_numpy(m).to(cuda)
    kw = dict(dropout_rate=rate, seed=99, kv_valid=kv_valid,
              key_mask=key_mask)
    out, lse = tfa.flash_dropout_attention_fwd(q, k, v, **kw)
    ref, ref_lse = tfa.flash_dropout_attention_reference(q, k, v, **kw)
    assert (out.float() - ref.float()).abs().max().item() <= _KERNEL_TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    got = tfa.flash_dropout_attention_bwd(q, k, v, do, ref, ref_lse, **kw)
    want = tfa.flash_dropout_attention_bwd_reference(q, k, v, do, ref,
                                                     ref_lse, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g.float()).all())
        assert _grad_close(g, w, dtype)
    again = tfa.flash_dropout_attention_bwd(q, k, v, do, ref, ref_lse, **kw)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.cuda
def test_kernel_mask_is_the_plain_mask(cuda):
    """With v = identity columns the output is the dropped probability
    matrix itself: its zero pattern must be the plain function's mask, and
    the keep rate within 3 sigma of 1 - rate."""
    b, h, s, d, rate, seed = 2, 2, 64, 64, 0.1, 5 + (3 << 33)
    q = torch.zeros(b, h, s, d, device=cuda)
    v = torch.eye(s, d, device=cuda).expand(b, h, s, d).contiguous()
    out, _ = tfa.flash_dropout_attention_fwd(q, q, v, dropout_rate=rate,
                                             seed=seed)
    keep = tfa.dropout_keep_mask(seed, rate, b * h, s, s, cuda)
    assert torch.equal(out.reshape(b * h, s, s) > 0, keep)
    n = keep.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(keep.float().mean().item() - (1 - rate)) <= 3 * sigma
    other = tfa.dropout_keep_mask(seed + 1, rate, b * h, s, s, cuda)
    assert not torch.equal(keep, other)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_functions_launch_their_kernels(cuda, dtype):
    tfa.reset_launch_counts()
    qkv = torch.from_numpy(_randn(34, 2, 65, 3 * 4 * 16)).to(cuda, dtype)
    qkv.requires_grad_()
    tfa.packed_flash_attention(qkv, 4, dropout_rate=0.1, seed=3).sum().backward()
    q, k, v = (torch.from_numpy(_randn(35 + i, 2, 2, 40, 16)).to(cuda, dtype)
               .requires_grad_() for i in range(3))
    tfa.flash_dropout_attention(q, k, v, dropout_rate=0.1,
                                seed=4).sum().backward()
    tfa.flash_attention(q, k, v).sum().backward()
    bias = torch.zeros(1, 2, 40, 40, device=cuda, requires_grad=True)
    tfa.flash_attention(q, k, v, bias).sum().backward()
    torch.cuda.synchronize()
    assert qkv.grad.shape == qkv.shape and bias.grad.shape == bias.shape
    assert tfa.LAUNCHES == {
        "packed_attention": 1, "packed_attention_bwd": 1,
        "dropout_attention_fwd": 1, "dropout_attention_bwd": 2,
        "flash_attention": 2}


@pytest.mark.cuda
def test_unported_paths_raise_on_cuda(cuda):
    q = torch.zeros(1, 2, 8, 16, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tattn.dot_product_attention(
            q, q, q, mask=torch.ones(1, 1, 1, 8, dtype=torch.bool, device=cuda))
    big = torch.zeros(1, 1, 1300, 16, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfa.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="head dim"):
        tfa.packed_flash_attention(torch.zeros(1, 4, 3 * 2 * 8, device=cuda), 2)
