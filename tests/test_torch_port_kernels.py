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
from vision_transformers_tpu_torch.ops import fused_dense as tfd


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# fp32: summation order only. bf16: the plain version rounds the
# probabilities to bf16 before PV (as the TPU kernel does); the tensor-core
# kernels of rows 2 and 5 round them before they normalise, not after, and
# those of rows 1 and 3 round them where their plain versions do
# (unnormalised), against a running max where the plain versions take the
# row's; plus one rounding of the output, one bf16 step of 1.6e-2 at |out|
# 2-4 (which the tensor-core kernel reaches at D 64 with a bias).
_KERNEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# The bf16 kernels of rows 3 and 5 at Sk >= 1000, where |out| stays well
# below 1, times max(1, max|ref|): summation order and one bf16 rounding of
# the output. One skipped live 64-key tile moves the output by more.
_LONG_ROW_TOL = 3e-3


def _fwd_tol(dtype, sk, ref):
    if dtype == torch.bfloat16 and sk >= 1000:
        return _LONG_ROW_TOL * max(1.0, ref.float().abs().max().item())
    return _KERNEL_TOL[dtype]


def _nan_filled(b, s, heads, dh, dtype, cuda):
    """out and lse of a packed forward, filled with NaN: every element the
    kernel leaves unwritten shows."""
    return dict(out=torch.full((b, s, heads * dh), float("nan"), dtype=dtype,
                               device=cuda),
                lse=torch.full((b, s, heads), float("nan"), device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,heads,dh,kv_valid", [
    (2, 197, 12, 64, None), (32, 197, 12, 64, None),  # ViT-B/16 @224
    (2, 208, 12, 64, 197), (3, 49, 3, 32, None), (2, 197, 6, 32, 190),
    (1, 33, 2, 16, 30), (2, 130, 4, 16, None),
    # any other head dim, in the next tile (_PADDED_HEAD_DIMS)
    (2, 257, 16, 80, None),  # ViT-H/14 @224
    (2, 65, 3, 12, 60), (1, 70, 2, 96, None), (2, 40, 2, 128, 37),
    (1, 33, 2, 77, None), (2, 20, 3, 1, None)])
def test_packed_kernel_matches_plain(cuda, dtype, b, s, heads, dh, kv_valid):
    qkv = torch.from_numpy(_randn(22, b, s, 3 * heads * dh)).to(cuda, dtype)
    out, lse = tfa.packed_flash_attention_fwd(
        qkv, heads, kv_valid=kv_valid,
        **_nan_filled(b, s, heads, dh, dtype, cuda))
    ref, ref_lse = tfa.packed_flash_attention_reference(qkv, heads,
                                                        kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert not bool(out.isnan().any()) and not bool(lse.isnan().any())
    assert (out.float() - ref.float()).abs().max().item() <= _KERNEL_TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    again = tfa.packed_flash_attention_fwd(qkv, heads, kv_valid=kv_valid)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


# Shapes of the split-head kernels: (Sq, Sk, kv_valid, D). Sk 49 is below
# one 64-key tile of the bf16 kernels, Sq 1000 a ragged last query tile.
_SPLIT_SHAPES = [(49, 49, None, 32), (100, 25, None, 32), (70, 70, 60, 32),
                 (1000, 49, None, 64), (1000, 130, 120, 16),
                 (100, 100, None, 64),
                 # D 65-127 in the 128 tile (ViT-H/14 @384: D 80), odd D
                 (130, 70, None, 80), (70, 70, 60, 96), (49, 49, None, 77)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_lead", [None, 1, 2, 4])
@pytest.mark.parametrize("sq,sk,kv_valid,d", _SPLIT_SHAPES)
def test_flash_kernel_matches_plain(cuda, dtype, bias_lead, sq, sk, kv_valid,
                                    d):
    b, h = 4, 3
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
    again = tfa.flash_attention_fwd(q, k, v, bias, kv_valid=kv_valid)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


# Gradients, relative to the largest reference element (they grow with S).
# fp32: summation order and expf against torch.exp. bf16: the looser bound,
# for results that round at other points than what they are held against
# (row 4 against row 6, which rounds ds·scale where row 4 rounds ds), plus
# one rounding of the result.
_GRAD_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
# The bf16 backwards of rows 4, 6 and 7 run on the tensor cores and round pd
# and ds to bf16 before their products where their TPU kernels and plain
# versions do (row 4 ds before the scale, rows 6 and 7 ds·scale): what is
# left is summation order and one rounding of the result (up to 3.1e-3 at
# PVT stage 1 in chip_smoke.py's runs on an H100).
_MMA_GRAD_TOL = 5e-3


def _grad_close(got, ref, dtype, tol=None):
    tol = (_GRAD_TOL[dtype] if tol is None else tol) \
        * max(1.0, ref.float().abs().max().item())
    return (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,s,heads,dh,kv_valid", [
    (2, 197, 12, 64, None), (32, 197, 12, 64, None),  # ViT-B/16 @224
    (2, 208, 12, 64, 197), (4, 65, 4, 64, None), (2, 197, 6, 32, 190),
    (1, 33, 2, 16, 30),
    (2, 257, 16, 80, None),  # ViT-H/14 @224
    (1, 70, 2, 96, 64), (2, 40, 2, 128, None), (1, 33, 3, 12, 30),
    (1, 50, 2, 77, None)])
def test_packed_dropout_and_backward_match_plain(cuda, dtype, rate, b, s,
                                                 heads, dh, kv_valid):
    qkv = torch.from_numpy(_randn(27, b, s, 3 * heads * dh)).to(cuda, dtype)
    do = torch.from_numpy(_randn(28, b, s, heads * dh)).to(cuda, dtype)
    kw = dict(dropout_rate=rate, seed=1234 + (7 << 40), kv_valid=kv_valid)
    out, lse = tfa.packed_flash_attention_fwd(
        qkv, heads, **kw, **_nan_filled(b, s, heads, dh, dtype, cuda))
    ref, ref_lse = tfa.packed_flash_attention_reference(qkv, heads, **kw)
    again = tfa.packed_flash_attention_fwd(qkv, heads, **kw)
    assert not bool(out.isnan().any()) and not bool(lse.isnan().any())
    assert (out.float() - ref.float()).abs().max().item() <= _KERNEL_TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    # both backwards from the kernel's (out, lse), so only the backward
    # differs: the backward (either route) replays the forward's mask
    dqkv = tfa.packed_flash_attention_bwd(qkv, do, out, lse, heads, **kw)
    dref = tfa.packed_flash_attention_bwd_reference(qkv, do, out, lse, heads,
                                                    **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dqkv.float()).all())
    assert _grad_close(dqkv, dref, dtype)
    again = tfa.packed_flash_attention_bwd(qkv, do, out, lse, heads, **kw)
    assert torch.equal(dqkv, again)  # no atomics: equal from run to run


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("sq,sk,kv_valid,masked,d", [
    (49, 49, None, False, 32), (100, 25, None, False, 32),
    (70, 70, 60, True, 32), (257, 257, None, True, 32),
    (1000, 49, None, False, 64), (1000, 130, 120, True, 16),
    (130, 1000, 990, True, 64), (1000, 49, 40, True, 32),
    (300, 700, 650, True, 16), (300, 700, 650, False, 32),
    (257, 257, None, True, 80), (130, 200, 180, True, 96),
    (49, 49, None, False, 77)])
def test_dropout_kernels_match_plain(cuda, dtype, rate, sq, sk, kv_valid,
                                     masked, d):
    b, h = 3, 2
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
    assert (out.float() - ref.float()).abs().max().item() <= \
        _fwd_tol(dtype, sk, ref)
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    got = tfa.flash_dropout_attention_bwd(q, k, v, do, ref, ref_lse, **kw)
    want = tfa.flash_dropout_attention_bwd_reference(q, k, v, do, ref,
                                                     ref_lse, **kw)
    torch.cuda.synchronize()
    tol = _MMA_GRAD_TOL if dtype == torch.bfloat16 else None
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g.float()).all())
        assert _grad_close(g, w, dtype, tol)
    again = tfa.flash_dropout_attention_bwd(q, k, v, do, ref, ref_lse, **kw)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d", [(64, 64, 64), (100, 49, 32),
                                     (70, 130, 16)])
def test_backward_drops_exactly_the_plain_mask(cuda, sq, sk, d):
    """At rate 0.5 the bf16 backward's keep bits (four per Philox call,
    shared by shuffles, in both passes) are the plain mask. With q = 0 every
    probability is 1/Sk; with k = identity rows and v = 1, dq[i, c] is
    ds[i, c], and with do = 1, ds = p·(keep·2D − D·Σ_j pd)·scale is > 0
    exactly where kept (pass 1). With do = identity columns, dv[j, c] is
    pd[c, j] (pass 2). Then the backward against its plain version on
    random inputs."""
    b, h, rate, seed = 2, 2, 0.5, 11 + (5 << 36)
    g, bf16 = b * h, torch.bfloat16
    q = torch.zeros(b, h, sq, d, device=cuda, dtype=bf16)
    k = torch.eye(sk, d, device=cuda, dtype=bf16).expand(b, h, sk,
                                                          d).contiguous()
    v = torch.ones(b, h, sk, d, device=cuda, dtype=bf16)
    kw = dict(dropout_rate=rate, seed=seed)
    keep = tfa.dropout_keep_mask(seed, rate, g, sq, sk, cuda)
    out, lse = tfa.flash_dropout_attention_reference(q, k, v, **kw)
    dq, _, _ = tfa.flash_dropout_attention_bwd(q, k, v, torch.ones_like(q),
                                               out, lse, **kw)
    cols = min(sk, d)
    assert torch.equal(dq.reshape(g, sq, d)[:, :, :cols] > 0,
                       keep[:, :, :cols])
    eye = torch.eye(sq, d, device=cuda, dtype=bf16).expand(b, h, sq, d)
    _, _, dv = tfa.flash_dropout_attention_bwd(q, k, v, eye.contiguous(),
                                               out, lse, **kw)
    rows = min(sq, d)
    assert torch.equal(
        dv.reshape(g, sk, d)[:, :, :rows].transpose(1, 2) > 0,
        keep[:, :rows])
    q, k, v, do = (torch.from_numpy(_randn(90 + i, b, h, n, d)).to(cuda, bf16)
                   for i, n in enumerate((sq, sk, sk, sq)))
    out, lse = tfa.flash_dropout_attention_reference(q, k, v, **kw)
    got = tfa.flash_dropout_attention_bwd(q, k, v, do, out, lse, **kw)
    want = tfa.flash_dropout_attention_bwd_reference(q, k, v, do, out, lse,
                                                     **kw)
    torch.cuda.synchronize()
    for gr, w in zip(got, want):
        assert _grad_close(gr, w, bf16, _MMA_GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d", [(64, 64, 64), (100, 49, 32),
                                     (70, 130, 16)])
def test_forward_drops_exactly_the_plain_mask(cuda, sq, sk, d):
    """At rate 0.5 the bf16 forward's keep bits (four per Philox call,
    shared by a shuffle) are the plain mask: with q = 0 and v = identity
    columns, out[i, c] is the dropped probability of key c, > 0 exactly
    where kept."""
    b, h, rate, seed = 2, 2, 0.5, 13 + (5 << 37)
    bf16 = torch.bfloat16
    q = torch.zeros(b, h, sq, d, device=cuda, dtype=bf16)
    v = torch.eye(sk, d, device=cuda, dtype=bf16).expand(b, h, sk,
                                                          d).contiguous()
    k = torch.zeros(b, h, sk, d, device=cuda, dtype=bf16)
    out, _ = tfa.flash_dropout_attention_fwd(q, k, v, dropout_rate=rate,
                                             seed=seed)
    keep = tfa.dropout_keep_mask(seed, rate, b * h, sq, sk, cuda)
    cols = min(sk, d)
    assert torch.equal(out.reshape(b * h, sq, d)[:, :, :cols] > 0,
                       keep[:, :, :cols])


def _hidden_from(b, sk, n, seed, dev):
    m = _masks(b, sk, seed=seed)
    m[:, n:] = False
    return torch.from_numpy(m).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,n,d", [(300, 700, 448, 32),
                                       (1000, 4704, 3584, 32),
                                       (200, 300, 64, 64), (70, 200, 128, 16)])
def test_skipped_tiles_leave_bits_unchanged(cuda, sq, sk, n, d):
    """The bf16 kernels of rows 3 and 5 skip 64-key tiles whose keys are all
    hidden: keys hidden from a tile boundary n on give out and lse bit-equal
    to the same call on K/V truncated to n keys, with and without a random
    mask below n; and the kernels' own tile counters show that they walked
    only the tiles below n."""
    b, h, bf16 = 2, 2, torch.bfloat16
    q, k, v = (torch.from_numpy(_randn(56 + i, b, h, s, d)).to(cuda, bf16)
               for i, s in enumerate((sq, sk, sk)))
    kt, vt = k[:, :, :n].contiguous(), v[:, :, :n].contiguous()
    cut = torch.arange(sk, device=cuda) < n
    ragged = _hidden_from(b, sk, n, 57, cuda)
    tiles, live = -(-sk // 64), n // 64
    for keep, keep_n in ((cut.expand(b, sk).contiguous(), None),
                         (ragged, ragged[:, :n].contiguous())):
        tfa.masked_tile_counts("flash_attention_large")  # zeroes them
        got = tfa.flash_attention_large_fwd(q, k, v, kv_mask=keep)
        walked, held = tfa.masked_tile_counts("flash_attention_large")
        assert held > 0 and walked * tiles == held * live
        want = tfa.flash_attention_large_fwd(q, kt, vt, kv_mask=keep_n)
        assert all(torch.equal(a, w) for a, w in zip(got, want))
        kw = dict(dropout_rate=0.1, seed=8 + (1 << 40))
        tfa.masked_tile_counts("dropout_attention")
        got = tfa.flash_dropout_attention_fwd(q, k, v, key_mask=keep, **kw)
        walked, held = tfa.masked_tile_counts("dropout_attention")
        assert held > 0 and walked * tiles == held * live
        want = tfa.flash_dropout_attention_fwd(q, kt, vt, key_mask=keep_n,
                                               **kw)
        assert all(torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.cuda
def test_bf16_kernels_refuse_misaligned_operands(cuda):
    """The tensor-core kernels read with 16-byte copies: a bf16 operand
    that is not 16-byte aligned raises, and nothing falls back."""
    b, h, s, d = 1, 2, 40, 32
    base = torch.zeros(b * h * s * d + 1, device=cuda, dtype=torch.bfloat16)
    q = base[1:].view(b, h, s, d)  # contiguous, 2 bytes off
    k = torch.zeros(b, h, s, d, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="misaligned"):
        tfa.flash_attention_fwd(q, k, k)
    out, lse = tfa.flash_attention_fwd(k, k, k)
    with pytest.raises(RuntimeError, match="misaligned"):
        tfa.flash_dropout_attention_bwd(q, k, k, k, out, lse,
                                        dropout_rate=0.0, seed=None)
    with pytest.raises(RuntimeError, match="misaligned"):
        tfa.flash_dropout_attention_fwd(q, k, k, dropout_rate=0.1, seed=3)
    with pytest.raises(RuntimeError, match="misaligned"):
        tfa.flash_attention_large_fwd(q, k, k)
    with pytest.raises(RuntimeError, match="misaligned"):
        tfa.flash_attention_large_fwd(k, k, k, out=q)
    qkv = torch.zeros(b * s * 96 + 1, device=cuda,
                      dtype=torch.bfloat16)[1:].view(b, s, 96)
    with pytest.raises(RuntimeError, match="misaligned"):
        tfa.packed_flash_attention_fwd(qkv, 2)
    x = base[1:1 + s * 64].view(s, 64)
    ones = torch.ones(64, device=cuda)
    w = torch.zeros(64, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="misaligned"):
        tfd.ln_dense_fwd(x, ones, ones, w)


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
    x, rows, w = _block_inputs(cuda, dtype, 2, 20, 32)
    x.requires_grad_()
    tfa.fused_attention_block(x, *rows[:2], w[0], rows[2], w[1], rows[3],
                              2).sum().backward()
    tfd.ln_dense(x, *rows[:2], w[0], rows[2]).sum().backward()
    torch.cuda.synchronize()
    assert qkv.grad.shape == qkv.shape and bias.grad.shape == bias.shape
    assert x.grad.shape == x.shape
    assert tfa.LAUNCHES == {
        "packed_attention": 1, "packed_attention_bwd": 1,
        "dropout_attention_fwd": 1, "dropout_attention_bwd": 2,
        "flash_attention": 2, "window_packed_attention": 0,
        "window_batched_attention": 0, "window_fused_slab_attention": 0,
        "window_fused_flat_attention": 0, "window_attention_bwd": 0,
        "fused_adam": 0, "flash_attention_large": 0, "flash_attention_bwd": 0,
        "ln_dense": 1, "fused_attention_block": 1}


# Window kernels (rows 9, 11, 12, 13). fp32: summation order and expf
# against torch.exp on outputs of magnitude <= 4. bf16: kernels and plain
# version round the normalised probabilities to bf16 before PV, as the TPU
# kernels do, so fp32 summation order can move a rounding by one step: one
# bf16 step at |out| in [2, 4) (2^-6), where all but a few of the largest of
# these outputs lie, and at most _WINDOW_DIFFERING_MAX of the elements differ at all (0.051%
# at most in chip_smoke.py's runs on an H100). Rounding the probabilities at
# another point moves far more.
_WINDOW_TOL = {torch.float32: 5e-6, torch.bfloat16: 1.6e-2}
_WINDOW_DIFFERING_MAX = 5e-3
# The bf16 window backward (row 10) rounds p for dv and ds·scale for dq and
# dk where its plain version does: summation order and one rounding of the
# result, one bf16 step at the largest element at most (2^-7 relative), and
# at most _WINDOW_DIFFERING_MAX of dqkv's elements differ at all.
_WINDOW_GRAD_TOL = 8e-3


def _window_close(out, ref, dtype):
    """out within _WINDOW_TOL of ref; in bf16 also bit-equal to it in all
    but _WINDOW_DIFFERING_MAX of the elements."""
    err = (out.float() - ref.float()).abs().max().item()
    share = (out != ref).float().mean().item()
    return err <= _WINDOW_TOL[dtype] and (
        dtype == torch.float32 or share <= _WINDOW_DIFFERING_MAX)

_WINDOW_SHAPES = [
    # g, n, heads, dh, nW'
    (256, 49, 3, 32, 64),   # Swin-T stage 1, shifted
    (147, 64, 3, 32, 49),   # SwinV2-T stage 1: nW' = 49 against any grouping
    (64, 49, 6, 32, 16),    # Swin-T stage 2
    (10, 49, 24, 32, 1),    # Swin-T stage 4: few windows, many heads
    (37, 16, 2, 16, 1),     # CIFAR window, ragged last block
    (7, 128, 1, 64, 7),     # the largest window and head dim
    (5, 49, 3, 32, 0),      # no bias
    (15, 9, 2, 32, 3),      # a 3 x 3 window: 16 keys, 4 windows a block
    (15, 25, 2, 32, 3),     # a 5 x 5 window: 32 keys (the only shape that
                            # takes them), nW' 3 across blocks of 2 windows
    (9, 25, 3, 64, 1),
    (40, 49, 2, 32, 1),     # the batched kernel: one step a block
    (8192, 49, 3, 32, 1),   # G·H 24 576: the batched kernel's longest run
    (2048, 49, 2, 32, 0),   # Twins-SVT-S's LSA at batch 32, no bias:
    (512, 49, 4, 32, 0),    # stages 1, 2 and 4
    (32, 49, 16, 32, 0),
]

# The kernels of rows 9-13 by route (ops/flash_attention.py's
# window_route): bf16 on the tensor cores, fp32 on the CUDA cores.
_WINDOW_ROUTE_NAMES = {
    ("window_packed_attention", torch.bfloat16): "window_packed_mma_kernel",
    ("window_packed_attention", torch.float32): "window_packed_kernel",
    ("window_attention_bwd", torch.bfloat16): "window_bwd_mma_kernel",
    ("window_attention_bwd", torch.float32): "window_bwd_kernel",
    ("window_batched_attention", torch.bfloat16): "window_batched_mma_kernel",
    ("window_batched_attention", torch.float32): "window_batched_kernel",
    ("window_fused_flat_attention", torch.bfloat16):
        "window_fused_flat_mma_kernel",
    ("window_fused_flat_attention", torch.float32): "window_fused_flat_kernel",
    ("window_fused_slab_attention", torch.bfloat16):
        "window_fused_slab_mma_kernel",
    ("window_fused_slab_attention", torch.float32): "window_fused_slab_kernel",
}


def _takes_window_route(fn, wrapper, dtype):
    """One call of ``fn`` launches the kernel of ``wrapper``'s route for
    ``dtype`` and not the other route's, by the kernel libraries' launch
    logs (``_build.launched``), not a profiler: runs of this file on an
    H100 saw the port's kernels missing from ``torch.profiler`` sessions at
    random while they had run."""
    from vision_transformers_tpu_torch.ops import _build

    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    want = _WINDOW_ROUTE_NAMES[(wrapper, dtype)]
    avoid = _WINDOW_ROUTE_NAMES[(wrapper, other)]
    torch.cuda.synchronize()
    _build.reset_launched()
    fn()
    torch.cuda.synchronize()
    got = _build.launched()
    ok = got.get(want, 0) > 0 and avoid not in got
    if not ok:  # shown with the failure
        print(f"{wrapper} {dtype} launched {got}")
    return ok


def _window_inputs(cuda, dtype, g, n, heads, dh, nwp, seed=40):
    qkv = torch.from_numpy(_randn(seed, g, n, 3 * heads * dh)).to(cuda, dtype)
    bias = None if nwp == 0 else \
        torch.from_numpy(_randn(seed + 1, nwp, heads, n, n)).to(cuda)
    return qkv, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn", ["window_packed_attention",
                                "window_batched_attention"])
@pytest.mark.parametrize("g,n,heads,dh,nwp", _WINDOW_SHAPES)
def test_window_kernels_match_plain(cuda, dtype, fn, g, n, heads, dh, nwp):
    qkv, bias = _window_inputs(cuda, dtype, g, n, heads, dh, nwp)
    tfa.reset_launch_counts()
    out = getattr(tfa, fn)(qkv, bias, heads)
    ref = tfa.window_attention_reference(qkv, bias, heads)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES[fn] == 1 and sum(tfa.LAUNCHES.values()) == 1
    assert out.shape == ref.shape and out.dtype == dtype
    assert _window_close(out, ref, dtype)
    assert torch.equal(getattr(tfa, fn)(qkv, bias, heads), out)
    assert _takes_window_route(lambda: getattr(tfa, fn)(qkv, bias, heads), fn,
                               dtype)


@pytest.mark.cuda
def test_window_masks_do_not_overflow(cuda):
    """A shift mask of -100 and a pad mask of -1e9 on top of the bias, in
    bf16: finite outputs equal to the plain version's, and finite gradients
    within their limits, on the tensor-core route of rows 9 and 10."""
    g, n, heads, dh = 8, 49, 3, 32
    qkv, bias = _window_inputs(cuda, torch.bfloat16, g, n, heads, dh, 4)
    bias[1, :, :, 40:] = -100.0
    bias[2, :, :, 25:] += -1e9
    bias[3, :, 10:, :10] = -100.0
    ref = tfa.window_attention_reference(qkv, bias, heads)
    for fn in (tfa.window_packed_attention, tfa.window_batched_attention):
        out = fn(qkv, bias, heads)
        assert bool(torch.isfinite(out.float()).all())
        assert _window_close(out, ref, torch.bfloat16)
    assert _takes_window_route(lambda: tfa.window_packed_attention(
        qkv, bias, heads), "window_packed_attention", torch.bfloat16)
    do = torch.from_numpy(_randn(52, g, n, heads * dh)).to(cuda, torch.bfloat16)
    ref, ref_db = tfa.window_attention_bwd_reference(qkv, bias, do, heads)
    got, got_db = tfa.window_attention_bwd(qkv, bias, do, heads)
    assert bool(torch.isfinite(got.float()).all())
    assert bool(torch.isfinite(got_db.float()).all())
    assert _grad_close(got, ref, torch.bfloat16, _WINDOW_GRAD_TOL)
    assert _grad_close(got_db, ref_db, torch.bfloat16, _WINDOW_GRAD_TOL)
    assert (got != ref).float().mean().item() <= _WINDOW_DIFFERING_MAX
    assert _takes_window_route(lambda: tfa.window_attention_bwd(
        qkv, bias, do, heads), "window_attention_bwd", torch.bfloat16)


_FUSED_SHAPES = [
    # b, hp, wp, window, shift, heads, dh, per-window bias (None: no bias)
    (2, 56, 56, 7, (3, 3), 3, 32, True),    # Swin-T stage 1: slab and flat
    (3, 28, 28, 7, (3, 3), 6, 32, True),    # stage 2 (flat): row and column wrap
    (2, 14, 14, 7, (3, 3), 12, 32, True),   # stage 3 (flat)
    (2, 14, 14, 7, (0, 0), 12, 32, False),  # stage 3 unshifted
    (3, 16, 8, 4, (1, 3), 2, 16, True),     # non-square, CIFAR window
    (1, 32, 32, 8, (4, 4), 2, 64, False),   # window 8, dh 64, shift without a mask
    (2, 14, 14, 7, (0, 0), 8, 32, None),    # Twins-SVT-S stage 3: no bias
]


def _fused_plans(b, hp, wp, win, heads, dh, nwp):
    """The plans the map has: flat always, slab where wp % 8 == 0."""
    geom = (b, hp, wp, win, win, heads, dh, nwp)
    plans = [tfa.window_fused_plan(*geom), tfa.window_fused_flat_plan(*geom)]
    return [p for p in plans if p is not None]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hp,wp,win,shift,heads,dh,per_window",
                         _FUSED_SHAPES)
def test_fused_window_kernels_match_plain(cuda, dtype, b, hp, wp, win, shift,
                                          heads, dh, per_window):
    n = win * win
    nwp = (hp // win) * (wp // win) if per_window else 1
    qkv = torch.from_numpy(_randn(42, b, hp, wp, 3 * heads * dh)).to(cuda, dtype)
    bias = None if per_window is None else \
        torch.from_numpy(_randn(43, nwp, heads, n, n)).to(cuda)
    ref = tfa.window_fused_reference(qkv, bias, heads, (win, win), shift)
    plans = _fused_plans(b, hp, wp, win, heads, dh, nwp)
    assert [p[0] for p in plans] == (["flat"] if wp % 8 else ["slab", "flat"])
    for plan in plans:
        _check_fused_launch(cuda, dtype, qkv, bias, ref, heads, win, shift, plan)


def _check_fused_launch(cuda, dtype, qkv, bias, ref, heads, win, shift, plan):
    kind = plan[0]
    out = torch.full(ref.shape, float("nan"), device=cuda, dtype=dtype)
    tfa.reset_launch_counts()
    got = tfa.fused_window_attention(qkv, bias, heads, (win, win), shift,
                                     plan=plan, out=out)
    torch.cuda.synchronize()
    assert got is out and tfa.LAUNCHES[f"window_fused_{kind}_attention"] == 1
    assert not bool(torch.isnan(out.float()).any())  # every element written
    assert _window_close(out, ref, dtype)
    assert torch.equal(tfa.fused_window_attention(
        qkv, bias, heads, (win, win), shift, plan=plan), out)
    assert _takes_window_route(lambda: tfa.fused_window_attention(
        qkv, bias, heads, (win, win), shift, plan=plan),
        f"window_fused_{kind}_attention", dtype)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hw,win,shift,heads,dh,per_window", [
    (32, 56, 7, 3, 3, 32, True),    # Swin-T stage 1, shifted: row 13's shape
    (32, 56, 7, 0, 3, 32, False),   # unshifted, shared bias
    (1, 56, 7, 3, 3, 32, True),     # bucket 1: rows split into short runs
    (2, 32, 4, 2, 2, 16, True),     # N 16: 4 windows a block step
    (2, 40, 5, 2, 2, 64, True),     # N 25 (2 windows a step), 8 a row
    (2, 24, 3, 1, 4, 32, None),     # N 9, no bias
    (1, 24, 4, 2, 2, 32, True),     # 6 windows a row: a half-full last step
])
def test_slab_kernel_matches_plain_and_flat(cuda, dtype, b, hw, win, shift,
                                            heads, dh, per_window):
    """Row 13 at shapes with wp % 8 == 0 (where the slab plan exists), N not
    a multiple of 16 among them: against its plain version into a
    NaN-filled output, reruns bit-equal, by its kernel's name, and against
    the flat kernel on the same map (both read the rolled windows through a
    row table, so in bf16 they may differ by summation order only)."""
    n = win * win
    nwp = (hw // win) ** 2 if per_window else 1
    qkv = torch.from_numpy(_randn(46, b, hw, hw, 3 * heads * dh)).to(cuda,
                                                                     dtype)
    bias = None if per_window is None else \
        torch.from_numpy(_randn(47, nwp, heads, n, n)).to(cuda)
    ref = tfa.window_fused_reference(qkv, bias, heads, (win, win),
                                     (shift, shift))
    plans = _fused_plans(b, hw, hw, win, heads, dh, nwp)
    assert [p[0] for p in plans] == ["slab", "flat"]
    slab, flat = (_check_fused_launch(cuda, dtype, qkv, bias, ref, heads,
                                      win, (shift, shift), plan)
                  for plan in plans)
    assert (slab.float() - flat.float()).abs().max().item() \
        <= _WINDOW_TOL[dtype]


@pytest.mark.cuda
def test_fused_window_section_stride(cuda):
    """Sections padded to 128 lanes (the TPU layout) are one value of the
    stride: real lanes equal the plain version's, pad lanes are zero."""
    b, hp, wp, heads, dh, sec = 2, 8, 8, 2, 32, 128
    qkv = torch.zeros(b, hp, wp, 3, sec, device=cuda)
    qkv[..., : heads * dh] = torch.from_numpy(
        _randn(44, b, hp, wp, 3, heads * dh)).to(cuda)
    qkv = qkv.reshape(b, hp, wp, 3 * sec)
    bias = torch.from_numpy(_randn(45, 4, heads, 16, 16)).to(cuda)
    ref = tfa.window_fused_reference(qkv, bias, heads, (4, 4), (2, 2),
                                     hd=heads * dh)
    for plan_fn in (tfa.window_fused_plan, tfa.window_fused_flat_plan):
        plan = plan_fn(b, hp, wp, 4, 4, heads, dh, 4, 4)
        out = tfa.fused_window_attention(qkv, bias, heads, (4, 4), (2, 2),
                                         dh=dh, plan=plan)
        assert out.shape == (b, hp, wp, sec)
        assert (out - ref).abs().max().item() <= 5e-6
        assert not bool(out[..., heads * dh:].any())


@pytest.mark.cuda
def test_window_kernels_are_forward_only_on_cuda(cuda):
    """They were, until the shared backward kernel: now a recorded gradient
    goes through ``window_attention_bwd``, once per backward; ``out=`` stays
    a forward-only convenience. A head dim outside the JAX window plans
    (24) raises before any launch."""
    qkv = torch.from_numpy(_randn(46, 4, 16, 3 * 2 * 16)).to(cuda)
    qkv.requires_grad_()
    for fn in (tfa.window_packed_attention, tfa.window_batched_attention):
        tfa.reset_launch_counts()
        (grad,) = torch.autograd.grad(fn(qkv, None, 2).sum(), qkv)
        assert tfa.LAUNCHES["window_attention_bwd"] == 1
        assert bool(torch.isfinite(grad).all())
    qmap = torch.from_numpy(_randn(47, 1, 8, 8, 3 * 2 * 16)).to(cuda)
    qmap.requires_grad_()
    for plan_fn in (tfa.window_fused_plan, tfa.window_fused_flat_plan):
        plan = plan_fn(1, 8, 8, 4, 4, 2, 16, 1)
        tfa.reset_launch_counts()
        out = tfa.fused_window_attention(qmap, None, 2, (4, 4), (2, 2),
                                         plan=plan)
        (grad,) = torch.autograd.grad(out.sum(), qmap)
        assert tfa.LAUNCHES["window_attention_bwd"] == 1
        assert bool(torch.isfinite(grad).all())
        with pytest.raises(ValueError, match="no gradient"):
            tfa.fused_window_attention(qmap, None, 2, (4, 4), (2, 2),
                                       plan=plan, out=torch.empty(
                                           1, 8, 8, 32, device=cuda))
    with torch.no_grad():  # a leaf that needs a gradient, but none recorded
        assert tfa.window_packed_attention(qkv, None, 2).shape == (4, 16, 32)
    with pytest.raises(ValueError, match="head dim"):  # 24 divides no 128
        tfa.window_packed_attention(
            torch.zeros(4, 16, 3 * 2 * 24, device=cuda), None, 2,
            plan=(1, 32))


# The window backward against its plain version: dqkv, in bf16 to
# _WINDOW_GRAD_TOL. dbias sums G/nW' windows of ds rounded to the compute
# dtype on both sides; the kernel's ds differs from the plain one by fp32
# summation order before that rounding, so a few terms land on the other
# side of a bf16 rounding: relative to the largest reference element, to the
# same limits.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,n,heads,dh,nwp", _WINDOW_SHAPES + [
    (6, 128, 2, 64, 3),     # the largest tile: one window per block
    (5, 100, 1, 64, 0)])
def test_window_backward_kernel_matches_plain(cuda, dtype, g, n, heads, dh,
                                              nwp):
    qkv, bias = _window_inputs(cuda, dtype, g, n, heads, dh, nwp)
    do = torch.from_numpy(_randn(48, g, n, heads * dh)).to(cuda, dtype)
    ref, ref_db = tfa.window_attention_bwd_reference(qkv, bias, do, heads)
    filled = torch.full_like(qkv, float("nan"))
    tfa.reset_launch_counts()
    got, got_db = tfa.window_attention_bwd(qkv, bias, do, heads, dqkv=filled)
    again, again_db = tfa.window_attention_bwd(qkv, bias, do, heads)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["window_attention_bwd"] == 2 and got is filled
    assert not bool(torch.isnan(got.float()).any())  # every element written
    tol = _WINDOW_GRAD_TOL if dtype == torch.bfloat16 else None
    assert _grad_close(got, ref, dtype, tol)
    assert dtype == torch.float32 or \
        (got != ref).float().mean().item() <= _WINDOW_DIFFERING_MAX
    assert torch.equal(got, again)  # no atomics: equal bits
    if bias is None:
        assert got_db is None and ref_db is None
    else:
        assert got_db.shape == bias.shape and got_db.dtype == bias.dtype
        assert _grad_close(got_db, ref_db, dtype, tol)
        assert torch.equal(got_db, again_db)
        no_db = tfa.window_attention_bwd(qkv, bias, do, heads,
                                         need_dbias=False)
        assert no_db[1] is None and torch.equal(no_db[0], got)
    assert _takes_window_route(lambda: tfa.window_attention_bwd(
        qkv, bias, do, heads), "window_attention_bwd", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["packed", "batched", "slab", "flat"])
def test_window_gradients_match_autograd_of_plain(cuda, kind):
    """fp32 gradients through each wrapper's autograd function against
    autograd of the plain forward (the second oracle); masks of -100 and
    -1e9 inside the bias."""
    b, hp, wp, win, heads, dh = 2, 16, 16, 4, 2, 32
    n, nw = win * win, (hp // win) * (wp // win)
    qmap = torch.from_numpy(_randn(49, b, hp, wp, 3 * heads * dh)).to(cuda)
    bias = torch.from_numpy(_randn(50, nw, heads, n, n)).to(cuda)
    bias[1, :, :, 12:] = -100.0
    bias[2, :, :, 9:] += -1e9
    do = torch.from_numpy(_randn(51, b, hp, wp, heads * dh)).to(cuda)

    def grads(fn, x, do_):
        x, bb = x.clone().requires_grad_(), bias.clone().requires_grad_()
        return torch.autograd.grad(fn(x, bb), (x, bb), do_)

    if kind in ("packed", "batched"):
        part = lambda t: t.reshape(b * nw, n, t.shape[-1])  # noqa: E731
        wrapper = getattr(tfa, f"window_{kind}_attention")
        got = grads(lambda x, bb: wrapper(x, bb, heads), part(qmap), part(do))
        ref = grads(lambda x, bb: tfa.window_attention_reference(x, bb, heads),
                    part(qmap), part(do))
    else:
        plan_fn = (tfa.window_fused_plan if kind == "slab"
                   else tfa.window_fused_flat_plan)
        plan = plan_fn(b, hp, wp, win, win, heads, dh, nw)
        got = grads(lambda x, bb: tfa.fused_window_attention(
            x, bb, heads, (win, win), (2, 2), plan=plan), qmap, do)
        ref = grads(lambda x, bb: tfa.window_fused_reference(
            x, bb, heads, (win, win), (2, 2)), qmap, do)
    for a, r in zip(got, ref):
        assert _grad_close(a, r, torch.float32)


@pytest.mark.cuda
def test_fused_window_backward_zeroes_pad_lanes(cuda):
    """Sections padded to 128 lanes: the map's gradient equals autograd of
    the plain version in the real lanes and is zero in the pad lanes."""
    b, hp, wp, heads, dh, sec = 2, 8, 8, 2, 32, 128
    qkv = torch.zeros(b, hp, wp, 3, sec, device=cuda)
    qkv[..., : heads * dh] = torch.from_numpy(
        _randn(52, b, hp, wp, 3, heads * dh)).to(cuda)
    qkv = qkv.reshape(b, hp, wp, 3 * sec)
    bias = torch.from_numpy(_randn(53, 4, heads, 16, 16)).to(cuda)
    do = torch.from_numpy(_randn(54, b, hp, wp, sec)).to(cuda)
    x = qkv.clone().requires_grad_()
    plan = tfa.window_fused_flat_plan(b, hp, wp, 4, 4, heads, dh, 4, 4)
    (got,) = torch.autograd.grad(tfa.fused_window_attention(
        x, bias, heads, (4, 4), (2, 2), dh=dh, plan=plan), x, do)
    y = qkv.clone().requires_grad_()
    (ref,) = torch.autograd.grad(tfa.window_fused_reference(
        y, bias, heads, (4, 4), (2, 2), hd=heads * dh), y, do)
    assert _grad_close(got, ref, torch.float32)
    pads = got.reshape(b, hp, wp, 3, sec)[..., heads * dh:]
    assert not bool(pads.any())


@pytest.mark.cuda
@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_fused_adam_kernel_matches_plain(cuda, weight_decay):
    """Three steps over a mixed list, in place and bit-equal to the plain
    version (the kernel rounds each operation on its own, in the plain
    version's order): leaves on both sides of 65 536 elements, ragged last
    vectors, a view not 16-byte aligned, and more leaves than one launch's
    table holds, so a step is two launches of adam_multi_kernel."""
    from vision_transformers_tpu_torch.ops import _build
    from vision_transformers_tpu_torch.ops import fused_adam as tadam

    shapes = [(300, 300), (65536,), (65539,), (131, 1001), (1000,), (7, 9),
              (65535,), (3,), (1,)] + [(i % 37 + 1,) for i in range(320)]
    rng = np.random.RandomState(55)
    make = lambda scale: [  # noqa: E731
        torch.from_numpy((scale * rng.randn(*s)).astype(np.float32)).to(cuda)
        for s in shapes]
    params, mu, nu = make(1.0), make(0.0), make(0.0)
    # a leaf that starts 4 bytes past a 16-byte boundary
    odd = torch.from_numpy(rng.randn(70001).astype(np.float32)).to(cuda)[1:]
    params.insert(3, odd)
    mu.insert(3, torch.zeros_like(odd))
    nu.insert(3, torch.zeros_like(odd))
    assert odd.data_ptr() % 16 and len(params) > tadam._TABLE_LEAVES
    ref = [[t.clone() for t in group] for group in (params, mu, nu)]
    ptrs = [t.data_ptr() for group in (params, mu, nu) for t in group]
    leaves = tadam.FusedAdamLeaves(params, mu, nu)
    tfa.reset_launch_counts()
    torch.cuda.synchronize()
    _build.reset_launched()
    for step in range(1, 4):
        grads = [torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
                 .to(cuda) for p in params]
        grads[0] = grads[0].t()  # not contiguous: the wrapper copies it
        leaves.update(grads, step, 1e-3, weight_decay=weight_decay)
        s = tadam.adam_scalars(step, 1e-3, weight_decay=weight_decay)
        for p, m, v, g in zip(*ref, grads):
            tadam.fused_adam_reference(p, m, v, g, s)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["fused_adam"] == 3 * 2
    assert _build.launched().get("adam_multi_kernel") == 3 * 2
    assert ptrs == [t.data_ptr() for group in (params, mu, nu) for t in group]
    for got, want in zip((params, mu, nu), ref):
        for a, r in zip(got, want):
            assert torch.equal(a, r)


@pytest.mark.cuda
def test_unported_paths_raise_on_cuda(cuda):
    """What the kernels refuse on the card: a bias on the streaming route
    (a key-padding mask, or Sq·Sk > 1.5 M) and a head dim of 0. A
    key-padding mask at rate 0 and a large bias-free S launch the streaming
    kernel; a small-S backward whose group does not fit a block's shared
    memory streams (fp32: the wide passes), and the fused block takes dh 20
    in its padded tile: neither is refused any more."""
    q = torch.zeros(1, 2, 8, 16, device=cuda)
    keep = torch.ones(1, 8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="bias"):
        tfa.flash_attention(q, q, q, torch.zeros(1, 2, 8, 8, device=cuda),
                            kv_mask=keep)
    big = torch.zeros(1, 1, 1300, 16, device=cuda)
    with pytest.raises(ValueError, match="bias"):
        tfa.flash_attention(big, big, big,
                            torch.zeros(1, 1, 1300, 1300, device=cuda))
    tfa.reset_launch_counts()
    tattn.dot_product_attention(q, q, q, mask=keep[:, None, None, :])
    tfa.flash_attention(big, big, big)
    assert tfa.LAUNCHES["flash_attention_large"] == 2
    with pytest.raises(ValueError, match="head dim 0"):
        tfa.packed_flash_attention(torch.zeros(1, 4, 0, device=cuda), 2)
    from vision_transformers_tpu_torch.ops import _build

    q4, k4, v4, do4 = (torch.from_numpy(_randn(170 + i, 1, 1, n, 64)).to(cuda)
                       for i, n in enumerate((4, 1000, 1000, 4)))
    assert tfa.flash_bwd_smem_bytes(4, 1000, 64) > tfa._SMEM_LIMIT
    out4, lse4 = tfa.flash_attention_fwd(q4, k4, v4)
    torch.cuda.synchronize()
    _build.reset_launched()
    got = tfa.flash_attention_bwd(q4, k4, v4, out4, lse4, do4)
    torch.cuda.synchronize()
    assert _build.launched() == {"flash_bwd_dq_wide_kernel": 1,
                                 "flash_bwd_dkv_wide_kernel": 1}
    want = tfa.flash_attention_bwd_reference(q4, k4, v4, out4, lse4, do4)
    assert all(_grad_close(g, r, torch.float32) for g, r in zip(got, want))
    x, rows, w = _block_inputs(cuda, torch.float32, 1, 8, 40)
    args = (x, *rows[:2], w[0], rows[2], w[1], rows[3], 2)   # dh 20
    _build.reset_launched()
    out = tfa.fused_attention_block(*args)
    torch.cuda.synchronize()
    assert _build.launched() == {"fused_block_padded_kernel": 1}
    assert _fused_close(out, tfa.fused_attention_block_reference(*args),
                        torch.float32)
    with pytest.raises(ValueError, match="fp32"):
        tfd.ln_dense(x, rows[0].bfloat16(), rows[1], w[0])


# The streaming forward (row 3) and the small-S backward (row 4).


def _masks(b, sk, seed=50, full=None):
    m = np.random.RandomState(seed).rand(b, sk) > 0.3
    m[:, 0] = True
    if full is not None:
        m[full] = False  # a fully masked image
    return m


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,sq,sk,d,kv_valid,masked", [
    (2, 4, 300, 300, 32, None, True),     # encoder-style self attention
    (2, 2, 100, 700, 32, 650, True),      # decoder cross attention, kv_valid
    (1, 2, 1300, 1300, 64, None, False),  # bias-free Sq·Sk > 1.5 M
    (3, 3, 70, 45, 16, 40, True),
    (2, 2, 1000, 49, 64, None, True),     # Sk below one 64-key tile
    (2, 2, 1000, 49, 16, 30, True),
    (2, 3, 1000, 1000, 16, 900, True),    # ragged Sq, kv_valid with a mask
    (2, 2, 1000, 700, 64, 650, True),
    (1, 2, 333, 4704, 32, None, False),
    (1, 2, 500, 1300, 64, 1000, False),   # kv_valid without a mask
    # any other head dim: 128 its own tile, the rest padded
    (1, 2, 1370, 1370, 80, None, False),  # ViT-H/14 @518
    (2, 4, 300, 300, 80, None, True),     # the DETR encoder's masks at D 80
    (2, 2, 300, 300, 12, None, True), (2, 2, 100, 700, 128, 650, True),
    (1, 2, 333, 500, 77, None, True), (1, 2, 200, 1300, 96, 1250, False)])
def test_large_kernel_matches_plain(cuda, dtype, b, h, sq, sk, d, kv_valid,
                                    masked):
    q = torch.from_numpy(_randn(51, b, h, sq, d)).to(cuda, dtype)
    k = torch.from_numpy(_randn(52, b, h, sk, d)).to(cuda, dtype)
    v = torch.from_numpy(_randn(53, b, h, sk, d)).to(cuda, dtype)
    mask = torch.from_numpy(_masks(b, sk)).to(cuda) if masked else None
    filled = torch.full_like(q, float("nan"))
    out, lse = tfa.flash_attention_large_fwd(q, k, v, kv_mask=mask,
                                             kv_valid=kv_valid, out=filled)
    ref, ref_lse = tfa.flash_attention_large_reference(
        q, k, v, kv_mask=mask, kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert out.data_ptr() == filled.data_ptr()
    assert not bool(torch.isnan(out.float()).any())  # every element written
    assert (out.float() - ref.float()).abs().max().item() <= \
        _fwd_tol(dtype, sk, ref)
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    again, _ = tfa.flash_attention_large_fwd(q, k, v, kv_mask=mask,
                                             kv_valid=kv_valid)
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_large_kernel_fully_masked_image_is_uniform(cuda, dtype):
    b, h, s, d = 3, 2, 200, 32
    q, k, v = (torch.from_numpy(_randn(54 + i, b, h, s, d)).to(cuda, dtype)
               for i in range(3))
    mask = torch.from_numpy(_masks(b, s, full=1)).to(cuda)
    out, _ = tfa.flash_attention_large_fwd(q, k, v, kv_mask=mask)
    want = tattn.mha_reference(q, k, v, mask=mask[:, None, None, :])
    torch.cuda.synchronize()
    assert (out.float() - want.float()).abs().max().item() <= \
        _KERNEL_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,sq,sk,d,kv_valid", [
    (2, 8, 100, 100, 32, None),   # the DETR decoder's self attention
    (2, 12, 197, 197, 64, None),  # ViT-B/16
    (2, 3, 70, 45, 16, 40),
    (1, 2, 33, 300, 32, 290),
    # any other head dim the shared-memory rule admits
    (2, 2, 100, 100, 80, None), (2, 3, 70, 45, 12, 40),
    (1, 2, 60, 100, 128, None), (1, 2, 33, 50, 77, 45)])
def test_small_s_backward_kernel_matches_plain(cuda, dtype, b, h, sq, sk, d,
                                               kv_valid):
    q = torch.from_numpy(_randn(57, b, h, sq, d)).to(cuda, dtype)
    k = torch.from_numpy(_randn(58, b, h, sk, d)).to(cuda, dtype)
    v = torch.from_numpy(_randn(59, b, h, sk, d)).to(cuda, dtype)
    do = torch.from_numpy(_randn(60, b, h, sq, d)).to(cuda, dtype)
    out, lse = tfa.flash_attention_reference(q, k, v, kv_valid=kv_valid)
    filled = tuple(torch.full_like(t, float("nan")) for t in (q, k, v))
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do, kv_valid=kv_valid,
                                  grads=filled)
    want = tfa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                             kv_valid=kv_valid)
    row6 = tfa.flash_dropout_attention_bwd(q, k, v, do, out, lse,
                                           dropout_rate=0.0, seed=None,
                                           kv_valid=kv_valid)
    torch.cuda.synchronize()
    tol = _MMA_GRAD_TOL if dtype == torch.bfloat16 else None
    for g, w, r in zip(got, want, row6):
        assert not bool(torch.isnan(g.float()).any())  # every element written
        assert _grad_close(g, w, dtype, tol)
        assert _grad_close(g, r, dtype)
    again = tfa.flash_attention_bwd(q, k, v, out, lse, do, kv_valid=kv_valid)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.cuda
def test_flash_attention_routes_its_backward(cuda, monkeypatch):
    """Under USE_PALLAS_BWD a small bias-free, mask-free shape takes row 4;
    with a kv_mask, or without the flag, the backward is row 6 at rate 0."""
    b, h, s, d = 2, 2, 60, 32
    q, k, v = (torch.from_numpy(_randn(61 + i, b, h, s, d)).to(cuda)
               .requires_grad_() for i in range(3))
    mask = torch.from_numpy(_masks(b, s)).to(cuda)
    for flag, kv_mask, want in ((True, None, "flash_attention_bwd"),
                                (True, mask, "dropout_attention_bwd"),
                                (False, None, "dropout_attention_bwd")):
        monkeypatch.setattr(tfa, "USE_PALLAS_BWD", flag)
        tfa.reset_launch_counts()
        tfa.flash_attention(q, k, v, kv_mask=kv_mask).sum().backward()
        got = {n: c for n, c in tfa.LAUNCHES.items() if c}
        fwd = "flash_attention" if kv_mask is None else "flash_attention_large"
        assert got == {fwd: 1, want: 1}, got


# The fused sub-block (row 8) and the fused LayerNorm + Dense (row 14).
# fp32: summation order only, relative to the largest output. bf16: the
# plain versions round the unnormalised probabilities to bf16 before PV (as
# the TPU kernel does) and the kernel keeps them fp32; every product's
# summation order can move a bf16 rounding by one step (2^-8 relative).
_FUSED_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _block_inputs(device, dtype, b, s, hd, seed=70):
    """x (B, S, hd) in dtype; fp32 rows gamma, beta, bqkv, bout; the two
    weights (in, out) in dtype."""
    x = torch.from_numpy(_randn(seed, b, s, hd)).to(device, dtype)
    rows = [1 + 0.1 * torch.from_numpy(_randn(seed + 1, hd)),
            0.1 * torch.from_numpy(_randn(seed + 2, hd)),
            0.1 * torch.from_numpy(_randn(seed + 3, 3 * hd)),
            0.1 * torch.from_numpy(_randn(seed + 4, hd))]
    w = [torch.from_numpy(_randn(seed + 5, hd, 3 * hd)) / hd ** 0.5,
         torch.from_numpy(_randn(seed + 6, hd, hd)) / hd ** 0.5]
    return (x, [r.to(device) for r in rows], [t.to(device, dtype) for t in w])


def _fused_close(got, want, dtype):
    scale = max(1.0, want.float().abs().max().item())
    return (got.float() - want.float()).abs().max().item() \
        <= _FUSED_TOL[dtype] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,heads,dh", [
    (2, 197, 12, 64),   # ViT-B/16
    (1, 198, 12, 64),   # DeiT-B at bucket 1
    (2, 197, 6, 64),    # T2T-ViT-14
    (3, 33, 4, 32), (2, 17, 2, 16)])
def test_fused_block_kernel_matches_plain(cuda, dtype, b, s, heads, dh):
    x, rows, w = _block_inputs(cuda, dtype, b, s, heads * dh)
    args = (x, rows[0], rows[1], w[0], rows[2], w[1], rows[3], heads)
    out = tfa.fused_attention_block_fwd(*args,
                                        out=torch.full_like(x, float("nan")))
    want = tfa.fused_attention_block_reference(*args)
    torch.cuda.synchronize()
    assert not bool(torch.isnan(out.float()).any())  # every element written
    assert _fused_close(out, want, dtype)
    assert torch.equal(tfa.fused_attention_block_fwd(*args), out)
    # torch's (out, in) weights read through transposed views
    views = [t.t().contiguous().t() for t in w]
    assert torch.equal(tfa.fused_attention_block_fwd(
        x, rows[0], rows[1], views[0], rows[2], views[1], rows[3], heads), out)


@pytest.mark.cuda
def test_fused_block_gradients_match_autograd_of_plain(cuda):
    x, rows, w = _block_inputs(cuda, torch.float32, 2, 50, 64)
    leaves = [x, rows[0], rows[1], w[0], rows[2], w[1], rows[3]]
    do = torch.from_numpy(_randn(79, *x.shape)).to(cuda)
    grads = []
    for fn in (tfa.fused_attention_block, tfa.fused_attention_block_reference):
        ts = [t.detach().clone().requires_grad_() for t in leaves]
        fn(*ts, 4).backward(do)
        grads.append([t.grad for t in ts])
    for g, r in zip(*grads):
        scale = max(1.0, r.abs().max().item())
        assert (g - r).abs().max().item() <= 5e-5 * scale


# Row 8 in bf16 on the tensor cores (fused_block_mma_kernel) at the shapes of
# the flag-on ViT family: ViT-B/16 at batch 32 and 1, DeiT-B (S 198),
# T2T-ViT-14 (6 heads). Beside the limit a planted fault: the plain output
# with one 16-wide k slice of Wout left out must exceed it.
@pytest.mark.cuda
@pytest.mark.parametrize("b,s,heads,dh", [
    (32, 197, 12, 64), (32, 198, 12, 64), (32, 197, 6, 64), (1, 197, 12, 64)])
def test_fused_block_tensor_cores_at_path_shapes(cuda, b, s, heads, dh):
    x, rows, w = _block_inputs(cuda, torch.bfloat16, b, s, heads * dh)
    args = (x, rows[0], rows[1], w[0], rows[2], w[1], rows[3], heads)
    views = (x, rows[0], rows[1], w[0].t().contiguous().t(), rows[2],
             w[1].t().contiguous().t(), rows[3], heads)
    for a in (args, views):
        assert tfa.fused_block_route(torch.bfloat16, heads * dh, heads,
                                     (*a[3].stride(), *a[5].stride())) \
            == "tensor_cores"
    out = tfa.fused_attention_block_fwd(*args,
                                        out=torch.full_like(x, float("nan")))
    want = tfa.fused_attention_block_reference(*args)
    cut = w[1].clone()
    cut[368:384] = 0
    fault = tfa.fused_attention_block_reference(
        *args[:5], cut, rows[3], heads)
    torch.cuda.synchronize()
    assert not bool(torch.isnan(out.float()).any())  # every element written
    assert _fused_close(out, want, torch.bfloat16)
    assert not _fused_close(fault, want, torch.bfloat16)
    # the same bits from a rerun and from torch's (out, in) weights
    for a in (args, views):
        assert torch.equal(tfa.fused_attention_block_fwd(*a), out)
    # and from the four phases as ordered launches of their own (the
    # measurement entry), which read what an earlier phase wrote only after
    # a kernel boundary
    assert torch.equal(
        tfa._measure_fused_block_phases(*args, (0, 1, 2, 3)), out)


# Row 8 at head dims other than 16, 32 and 64: the next tile (dh 12: 16;
# 48: 64; 80 and 96: 128) or the wide one (160, 256), on both routes, by
# kernel name. Into a NaN-filled output, reruns and torch's (out, in)
# weights bit-equal, the four phases of the tensor-core route bit-equal to
# its one launch, beside a planted fault (one 16-wide k slice of Wout left
# out, inside the width).
_BLOCK_HEAD_DIMS = [(12, 8), (48, 8), (80, 16), (96, 8), (160, 4), (256, 3)]


def _block_kernel(dh, dtype):
    stem = "fused_block_mma" if dtype == torch.bfloat16 else "fused_block"
    kind = "" if dh in (16, 32, 64) else "_wide" if dh > 128 else "_padded"
    return f"{stem}{kind}_kernel"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,heads", _BLOCK_HEAD_DIMS)
def test_fused_block_other_head_dims_match_plain(cuda, dtype, dh, heads):
    from vision_transformers_tpu_torch.ops import _build

    b, s, hd = 4, 197, heads * dh
    x, rows, w = _block_inputs(cuda, dtype, b, s, hd)
    args = (x, rows[0], rows[1], w[0], rows[2], w[1], rows[3], heads)
    assert tfa.fused_block_supported(hd, heads)
    assert tfa.fused_block_route(dtype, hd, heads,
                                 (*w[0].stride(), *w[1].stride())) == (
        "tensor_cores" if dtype == torch.bfloat16 else "cuda_cores")
    torch.cuda.synchronize()
    _build.reset_launched()
    out = tfa.fused_attention_block_fwd(*args,
                                        out=torch.full_like(x, float("nan")))
    torch.cuda.synchronize()
    assert _build.launched() == {_block_kernel(dh, dtype): 1}
    want = tfa.fused_attention_block_reference(*args)
    cut = w[1].clone()
    k0 = min(368, hd - 16)
    cut[k0:k0 + 16] = 0
    fault = tfa.fused_attention_block_reference(*args[:5], cut, rows[3],
                                                heads)
    torch.cuda.synchronize()
    assert not bool(torch.isnan(out.float()).any())  # every element written
    assert _fused_close(out, want, dtype)
    assert not _fused_close(fault, want, dtype)
    views = (x, rows[0], rows[1], w[0].t().contiguous().t(), rows[2],
             w[1].t().contiguous().t(), rows[3], heads)
    for a in (args, views):
        assert torch.equal(tfa.fused_attention_block_fwd(*a), out)
    if dtype == torch.bfloat16:
        assert torch.equal(
            tfa._measure_fused_block_phases(*args, (0, 1, 2, 3)), out)


# Row 4 at the shapes its shared-memory rule refused before the route became
# the JAX score budget alone: ViT-B/16's widths at 3 heads split (G 96, S
# 197, D 256, the wide passes), S 512 at D 128 (bf16 the tensor-core passes,
# fp32 past the resident kernel: the streaming passes) and at D 256.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,s,d", [(96, 197, 256), (16, 512, 128),
                                   (16, 512, 256)])
def test_small_s_backward_at_every_routed_shape(cuda, dtype, g, s, d):
    from vision_transformers_tpu_torch.ops import _build

    assert tfa.flash_bwd_supported(s, s, d)
    q, k, v, do = (torch.from_numpy(_randn(140 + i, 1, g, s, d)).to(
        cuda, dtype) for i in range(4))
    out, lse = tfa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    _build.reset_launched()
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do, grads=tuple(
        torch.full_like(t, float("nan")) for t in (q, k, v)))
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        names = ("flash_bwd_dq_mma_kernel", "flash_bwd_dkv_mma_kernel")
        names = names if d == 128 else tuple(_wide(n, dtype) for n in names)
    else:  # d > 128, or past the resident kernel: the streaming passes
        names = ("flash_bwd_dq_wide_kernel", "flash_bwd_dkv_wide_kernel")
    assert _build.launched() == {n: 1 for n in names}
    want = tfa.flash_attention_bwd_reference(q, k, v, out, lse, do)
    tol = _MMA_GRAD_TOL if dtype == torch.bfloat16 else None
    for g_, w_ in zip(got, want):
        assert not bool(torch.isnan(g_.float()).any())
        assert _grad_close(g_, w_, dtype, tol)
    again = tfa.flash_attention_bwd(q, k, v, out, lse, do)
    assert all(torch.equal(a, g_) for a, g_ in zip(again, got))


@pytest.mark.cuda
def test_int8_matmul_at_k100_n36_bit_equal_to_the_cpu(cuda):
    """K and N off torch._int_mm's multiples of 8 are zero-padded on the
    card as on the CPU: the same bits, at 5 rows (padded to 17) and 40."""
    from vision_transformers_tpu_torch.ops import quant

    w = torch.from_numpy(_randn(150, 36, 100)) * 0.1
    bias = torch.from_numpy(_randn(151, 36)) * 0.1
    kq, ks = quant.quantize_kernel(w)
    for rows in (5, 40):
        x = torch.from_numpy(_randn(152 + rows, rows, 100))
        want = quant.int8_matmul(x, kq, ks, bias)
        got = quant.int8_matmul(x.to(cuda), kq.to(cuda), ks.to(cuda),
                                bias.to(cuda))
        assert torch.equal(got.cpu(), want)


# Row 7 in bf16 on the tensor cores (packed_bwd_*_mma_kernel) at the ViT
# paths' shapes (ViT-B/16 and T2T-ViT-14 at batch 32, vit_tiny at 64) and at
# dh 32 and 16, from the forward's out and lse, relative to max(1,
# max|ref|): it rounds pd and ds where its plain version does.
@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,s,heads,dh", [
    (32, 197, 12, 64), (32, 197, 6, 64), (64, 65, 4, 64), (4, 100, 4, 32),
    (2, 70, 3, 16)])
def test_packed_backward_tensor_cores_at_path_shapes(cuda, rate, b, s, heads,
                                                     dh):
    bf16 = torch.bfloat16
    qkv = torch.from_numpy(_randn(29, b, s, 3 * heads * dh)).to(cuda, bf16)
    do = torch.from_numpy(_randn(30, b, s, heads * dh)).to(cuda, bf16)
    kw = dict(dropout_rate=rate, seed=4321 + (3 << 40))
    out, lse = tfa.packed_flash_attention_fwd(qkv, heads, **kw)
    dqkv = tfa.packed_flash_attention_bwd(
        qkv, do, out, lse, heads, **kw,
        dqkv=torch.full_like(qkv, float("nan")))
    dref = tfa.packed_flash_attention_bwd_reference(qkv, do, out, lse, heads,
                                                    **kw)
    torch.cuda.synchronize()
    assert not bool(dqkv.isnan().any())  # every element written
    assert _grad_close(dqkv, dref, bf16, _MMA_GRAD_TOL)
    assert torch.equal(
        tfa.packed_flash_attention_bwd(qkv, do, out, lse, heads, **kw), dqkv)
    if rate > 0:  # the next seed's mask is another function
        other = tfa.packed_flash_attention_bwd_reference(
            qkv, do, out, lse, heads, dropout_rate=rate, seed=kw["seed"] + 1)
        assert not _grad_close(other, dref, bf16, _MMA_GRAD_TOL)


@pytest.mark.cuda
def test_rows_7_and_8_refuse_what_no_kernel_takes(cuda):
    """Row 7 takes bf16 (the tensor cores) and fp32 (the CUDA cores) at
    every head dim (dh 80 launches its padded kernels, dh 129 its wide
    ones), and so does row 8 (dh 80 its padded kernel, no refusal); a
    float16 operand or head dim 0 raises before any launch. Rows 7 and 8
    on the tensor cores copy 16 bytes at a time: a bf16 operand 2 bytes off
    raises. Nothing falls back."""
    bf16 = torch.bfloat16
    b, s, heads, dh = 1, 40, 2, 32
    qkv = torch.zeros(b, s, 3 * heads * dh, device=cuda, dtype=bf16)
    out, lse = tfa.packed_flash_attention_fwd(qkv, heads)
    half = qkv.half()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.packed_flash_attention_bwd(half, out.half(), out.half(), lse,
                                       heads)
    from vision_transformers_tpu_torch.ops import _build

    wide = torch.zeros(b, s, 3 * 80, device=cuda, dtype=bf16)
    w_out, w_lse = tfa.packed_flash_attention_fwd(wide, 1)
    _build.reset_launched()
    tfa.packed_flash_attention_bwd(wide, w_out, w_out, w_lse, 1)
    torch.cuda.synchronize()
    assert _build.launched() == {"packed_bwd_dq_mma_padded_kernel": 1,
                                 "packed_bwd_dkv_mma_padded_kernel": 1}
    wider = torch.zeros(b, s, 3 * 129, device=cuda, dtype=bf16)
    w_out, w_lse = tfa.packed_flash_attention_fwd(wider, 1)
    _build.reset_launched()
    tfa.packed_flash_attention_bwd(wider, w_out, w_out, w_lse, 1)
    torch.cuda.synchronize()
    assert _build.launched() == {"packed_bwd_dq_mma_wide_kernel": 1,
                                 "packed_bwd_dkv_mma_wide_kernel": 1}
    empty = torch.zeros(b, s, 0, device=cuda, dtype=bf16)
    with pytest.raises(ValueError, match="head dim 0"):
        tfa.packed_flash_attention_bwd(empty, empty, empty, lse[..., :1], 1)
    off = torch.zeros(qkv.numel() + 8, device=cuda, dtype=bf16)
    with pytest.raises(RuntimeError, match="misaligned"):
        tfa.packed_flash_attention_bwd(off[1:1 + qkv.numel()].view_as(qkv),
                                       out, out, lse, heads)
    with pytest.raises(RuntimeError, match="misaligned"):
        tfa.packed_flash_attention_bwd(
            qkv, out, out, lse, heads,
            dqkv=off[1:1 + qkv.numel()].view_as(qkv))
    xh, rh, wh = _block_inputs(cuda, bf16, b, s, 2 * 80)
    _build.reset_launched()
    tfa.fused_attention_block_fwd(xh, rh[0], rh[1], wh[0], rh[2], wh[1],
                                  rh[3], 2)
    torch.cuda.synchronize()
    assert _build.launched() == {"fused_block_mma_padded_kernel": 1}
    x, rows, w = _block_inputs(cuda, bf16, b, s, heads * dh)
    x_off = off[1:1 + x.numel()].view_as(x)
    x_off.copy_(x)
    with pytest.raises(RuntimeError, match="misaligned"):
        tfa.fused_attention_block_fwd(x_off, rows[0], rows[1], w[0], rows[2],
                                      w[1], rows[3], heads)


# Row 14's cases: in bf16 the tensor-core kernel (D and N multiples of 8;
# 128 × 128 tiles, 32-wide k steps) but for the N 70 case, which takes the
# CUDA-core kernel by ln_dense_route; fp32 the CUDA-core kernel throughout.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,n,activation,with_bias", [
    (394, 768, 2304, None, True),         # [ln_1 + QKV], ViT-B, 2 images
    (394, 768, 3072, "gelu_tanh", True),  # [ln_2 + fc1 + GELU]
    (6301, 768, 2312, None, False),       # ragged R and N, no bias
    (6301, 768, 200, "gelu_tanh", False),
    (130, 72, 136, "gelu_erf", True),     # D not a multiple of 32
    (101, 96, 70, "gelu_erf", False),     # ragged rows and columns, no bias
    (7, 40, 64, None, False)])
def test_ln_dense_kernel_matches_plain(cuda, dtype, rows, d, n, activation,
                                       with_bias):
    x = torch.from_numpy(_randn(80, rows, d)).to(cuda, dtype)
    g = (1 + 0.1 * torch.from_numpy(_randn(81, d))).to(cuda)
    b = (0.1 * torch.from_numpy(_randn(82, d))).to(cuda)
    w = (torch.from_numpy(_randn(83, d, n)) / d ** 0.5).to(cuda, dtype)
    bias = (0.1 * torch.from_numpy(_randn(84, n))).to(cuda) if with_bias \
        else None
    kw = dict(activation=activation)
    out = tfd.ln_dense_fwd(x, g, b, w, bias, **kw, out=torch.full(
        (rows, n), float("nan"), dtype=dtype, device=cuda))
    want = tfd.ln_dense_reference(x, g, b, w, bias, **kw)
    torch.cuda.synchronize()
    assert not bool(torch.isnan(out.float()).any())
    assert _fused_close(out, want, dtype)
    assert torch.equal(tfd.ln_dense_fwd(x, g, b, w, bias, **kw), out)
    wt = w.t().contiguous().t()  # a torch (N, D) weight, transposed
    assert torch.equal(tfd.ln_dense_fwd(x, g, b, wt, bias, **kw), out)


@pytest.mark.cuda
def test_ln_dense_gradients_match_autograd_of_plain(cuda):
    leaves = [torch.from_numpy(_randn(85, 3, 40, 64)),
              1 + 0.1 * torch.from_numpy(_randn(86, 64)),
              0.1 * torch.from_numpy(_randn(87, 64)),
              torch.from_numpy(_randn(88, 64, 96)) / 8,
              0.1 * torch.from_numpy(_randn(89, 96))]
    dy = torch.from_numpy(_randn(90, 3, 40, 96)).to(cuda)
    grads = []
    for fn in (tfd.ln_dense, tfd.ln_dense_reference):
        ts = [t.to(cuda).requires_grad_() for t in leaves]
        fn(*ts, activation="gelu_tanh").backward(dy)
        grads.append([t.grad for t in ts])
    for g, r in zip(*grads):
        scale = max(1.0, r.abs().max().item())
        assert (g - r).abs().max().item() <= 5e-5 * scale


# Rows 2, 5 and 6 at head dims other than 16, 32 and 64: TNT's (inner
# attention D 12 at S 4, outer D 128 at S 17), D 20 and 40 (the padded tiles
# 32 and 64) and an odd D 7 (2-byte copies). D 128 is an instantiation of
# its own; the others run in the next tile with zero columns past D.
_OTHER_DIM_SHAPES = [(4, 4, None, 12), (17, 17, None, 128),
                     (100, 100, 90, 12), (130, 70, None, 20),
                     (70, 200, 180, 128), (49, 49, None, 7),
                     (65, 65, None, 40)]


def _split_route(d, name):
    """The kernel a split-head launch of head dim d takes in bf16."""
    return name if d in (16, 32, 64, 128) else name.replace(
        "_kernel", "_padded_kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_lead", [None, 2])
@pytest.mark.parametrize("sq,sk,kv_valid,d", _OTHER_DIM_SHAPES)
def test_flash_kernel_other_head_dims(cuda, dtype, bias_lead, sq, sk,
                                      kv_valid, d):
    from vision_transformers_tpu_torch.ops import _build

    b, h = 4, 3
    q = torch.from_numpy(_randn(23, b, h, sq, d)).to(cuda, dtype)
    k = torch.from_numpy(_randn(24, b, h, sk, d)).to(cuda, dtype)
    v = torch.from_numpy(_randn(25, b, h, sk, d)).to(cuda, dtype)
    bias = None if bias_lead is None else \
        torch.from_numpy(_randn(26, bias_lead, h, sq, sk)).to(cuda)
    _build.reset_launched()
    out, lse = tfa.flash_attention_fwd(q, k, v, bias, kv_valid=kv_valid)
    torch.cuda.synchronize()
    name = "flash_fwd_mma_kernel" if dtype == torch.bfloat16 \
        else "flash_fwd_kernel"
    assert _build.launched() == {_split_route(d, name): 1}
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, bias,
                                                 kv_valid=kv_valid)
    assert (out.float() - ref.float()).abs().max().item() <= _KERNEL_TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    again = tfa.flash_attention_fwd(q, k, v, bias, kv_valid=kv_valid)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("sq,sk,kv_valid,d", _OTHER_DIM_SHAPES)
def test_dropout_kernels_other_head_dims(cuda, dtype, rate, masked, sq, sk,
                                         kv_valid, d):
    from vision_transformers_tpu_torch.ops import _build

    b, h = 3, 2
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
    _build.reset_launched()
    out, lse = tfa.flash_dropout_attention_fwd(q, k, v, **kw)
    got = tfa.flash_dropout_attention_bwd(q, k, v, do, out, lse, **kw)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        names = ("drop_fwd_mma_kernel", "drop_bwd_dq_mma_kernel",
                 "drop_bwd_dkv_mma_kernel")
    else:
        names = ("drop_fwd_kernel", "drop_bwd_dq_kernel",
                 "drop_bwd_dkv_kernel")
    launched = _build.launched()
    assert all(launched.get(_split_route(d, n)) == 1 for n in names)
    ref, ref_lse = tfa.flash_dropout_attention_reference(q, k, v, **kw)
    assert (out.float() - ref.float()).abs().max().item() <= \
        _fwd_tol(dtype, sk, ref)
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    got = tfa.flash_dropout_attention_bwd(q, k, v, do, ref, ref_lse, **kw)
    want = tfa.flash_dropout_attention_bwd_reference(q, k, v, do, ref,
                                                     ref_lse, **kw)
    torch.cuda.synchronize()
    tol = _MMA_GRAD_TOL if dtype == torch.bfloat16 else None
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g.float()).all())
        assert _grad_close(g, w, dtype, tol)
    again = tfa.flash_dropout_attention_bwd(q, k, v, do, ref, ref_lse, **kw)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [12, 7])
def test_bf16_padded_operands_at_odd_row_offsets(cuda, d):
    """A bf16 D 12 row is 24 bytes: an operand that starts one row into a
    buffer is 8-byte, not 16-byte, aligned, and rows 2, 5 and 6 take it
    (4-byte copies) with the bits of the aligned call; 2 bytes off, an even
    D is refused (misaligned) and an odd one (2-byte loads) taken."""
    b, h, s, bf16 = 2, 3, 37, torch.bfloat16
    n = b * h * s * d

    def at(offset, seed):
        buf = torch.zeros(n + offset, device=cuda, dtype=bf16)
        buf[offset:] = torch.from_numpy(_randn(seed, n)).to(cuda, bf16)
        return buf[offset:].view(b, h, s, d)

    aligned = [at(0, 60 + i) for i in range(4)]
    row_off = [at(d, 60 + i) for i in range(4)]
    assert row_off[0].data_ptr() % 16 != 0
    kw = dict(dropout_rate=0.1, seed=5)
    for fn in (lambda q, k, v, do: tfa.flash_attention_fwd(q, k, v),
               lambda q, k, v, do: tfa.flash_dropout_attention_fwd(q, k, v,
                                                                   **kw)):
        want, got = fn(*aligned), fn(*row_off)
        assert all(torch.equal(a, g) for a, g in zip(want, got))
    out, lse = tfa.flash_dropout_attention_fwd(*aligned[:3], **kw)
    want = tfa.flash_dropout_attention_bwd(*aligned, out, lse, **kw)
    got = tfa.flash_dropout_attention_bwd(*row_off, out, lse, **kw)
    assert all(torch.equal(a, g) for a, g in zip(want, got))
    two_off = at(1, 64)
    if d % 2 == 0:
        with pytest.raises(RuntimeError, match="misaligned"):
            tfa.flash_attention_fwd(two_off, *aligned[1:3])
    else:
        want = tfa.flash_attention_fwd(two_off.clone(), *aligned[1:3])
        got = tfa.flash_attention_fwd(two_off, *aligned[1:3])
        assert all(torch.equal(a, g) for a, g in zip(want, got))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_head_rule_refuses_other_dims(cuda, dtype):
    """Rows 1-7 take every D >= 1 and refuse D 0 before any launch, naming
    their rule; D 65 and 96 (once refused by rows 2, 5 and 6), D 12 (once
    refused by row 1) and D 129 (once refused by all) launch."""
    for d in (0,):
        q = torch.zeros(1, 1, 8, d, device=cuda, dtype=dtype)
        calls = (
            lambda: tfa.flash_attention_fwd(q, q, q),
            lambda: tfa.flash_dropout_attention_fwd(q, q, q,
                                                    dropout_rate=0.1, seed=1),
            lambda: tfa.flash_attention_large_fwd(q, q, q),
            lambda: tfa.flash_attention_bwd(
                q, q, q, q, torch.zeros(1, 1, 8, device=cuda), q),
            lambda: tfa.packed_flash_attention_fwd(
                torch.zeros(1, 8, 3 * 2 * d, device=cuda, dtype=dtype), 2))
        for call in calls:
            with pytest.raises(ValueError, match=r"D >= 1"):
                call()
    tfa.reset_launch_counts()
    for d in (65, 96, 129):
        q = torch.zeros(1, 1, 8, d, device=cuda, dtype=dtype)
        tfa.flash_attention_fwd(q, q, q)
        tfa.flash_dropout_attention_fwd(q, q, q, dropout_rate=0.1, seed=1)
    tfa.packed_flash_attention(torch.zeros(1, 4, 3 * 2 * 12, device=cuda,
                                           dtype=dtype), 2)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention"] == 3
    assert tfa.LAUNCHES["dropout_attention_fwd"] == 3
    assert tfa.LAUNCHES["packed_attention"] == 1


# Rows 1, 3, 4 and 7 at head dims other than 16, 32 and 64 (rows 2, 5 and 6
# in test_*_other_head_dims above): D 128 takes row 3's and row 4's own
# instantiation and rows 1 and 7's padded tile, any other D the padded
# kernels; by name in the launch log, both dtypes.
def _padded_routes(d, bf):
    mma = "_mma" if bf else ""
    own = d == 128
    packed = ({"packed_fwd_mma_padded_kernel": 1,
               "packed_bwd_dq_mma_padded_kernel": 1,
               "packed_bwd_dkv_mma_padded_kernel": 1} if bf else
              {"packed_fwd_padded_kernel": 1,
               "packed_bwd_dq_padded_kernel": 1,
               "packed_bwd_dkv_padded_kernel": 1})
    large = {f"flash_large{mma}_{'' if own else 'padded_'}kernel": 1}
    if bf:
        pad = "" if own else "padded_"
        small = {f"flash_bwd_dq_mma_{pad}kernel": 1,
                 f"flash_bwd_dkv_mma_{pad}kernel": 1}
    else:
        small = {f"flash_bwd_{'' if own else 'padded_'}kernel": 1}
    return packed, large, small


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [12, 77, 80, 96, 128])
def test_rows_1_3_4_7_take_every_head_dim(cuda, dtype, d):
    from vision_transformers_tpu_torch.ops import _build

    packed, large, small = _padded_routes(d, dtype == torch.bfloat16)
    qkv = torch.from_numpy(_randn(70, 2, 40, 3 * 2 * d)).to(cuda, dtype)
    kw = dict(dropout_rate=0.1, seed=5)
    _build.reset_launched()
    out, lse = tfa.packed_flash_attention_fwd(qkv, 2, **kw)
    tfa.packed_flash_attention_bwd(qkv, out, out, lse, 2, **kw)
    torch.cuda.synchronize()
    assert _build.launched() == packed
    q = torch.from_numpy(_randn(71, 2, 2, 90, d)).to(cuda, dtype)
    mask = torch.from_numpy(_masks(2, 90)).to(cuda)
    _build.reset_launched()
    out, _ = tfa.flash_attention_large_fwd(q, q, q, kv_mask=mask)
    torch.cuda.synchronize()
    assert _build.launched() == large
    ref, ref_lse = tfa.flash_attention_reference(q, q, q)
    _build.reset_launched()
    tfa.flash_attention_bwd(q, q, q, ref, ref_lse, q)
    torch.cuda.synchronize()
    assert _build.launched() == small


@pytest.mark.cuda
@pytest.mark.parametrize("dh,offset,takes", [
    (80, 2, False), (80, 8, True),   # 16-byte copies: 4 bytes off refused
    (12, 2, True), (12, 1, False),   # 4-byte copies: 2 bytes off refused
    (7, 1, True), (77, 3, True)])    # an odd dh: 2-byte loads, any offset
def test_packed_padded_copy_grain_follows_the_head_dim(cuda, dh, offset,
                                                       takes):
    """Rows 1 and 7 read the packed projection at a dh other than 16, 32
    and 64 with the widest copy every head offset h·dh keeps aligned: a bf16
    qkv `offset` elements into a buffer gives the aligned call's bits where
    that grain allows it, and is refused as misaligned where it does not."""
    b, s, heads, bf16 = 2, 37, 3, torch.bfloat16
    n = b * s * 3 * heads * dh
    buf = torch.zeros(n + offset, device=cuda, dtype=bf16)
    buf[offset:] = torch.from_numpy(_randn(72, n)).to(cuda, bf16)
    moved = buf[offset:].view(b, s, 3 * heads * dh)
    qkv = moved.clone()
    do = torch.from_numpy(_randn(73, b, s, heads * dh)).to(cuda, bf16)
    kw = dict(dropout_rate=0.1, seed=9)
    out, lse = tfa.packed_flash_attention_fwd(qkv, heads, **kw)
    want = tfa.packed_flash_attention_bwd(qkv, do, out, lse, heads, **kw)
    if not takes:
        with pytest.raises(RuntimeError, match="misaligned"):
            tfa.packed_flash_attention_fwd(moved, heads, **kw)
        return
    got = tfa.packed_flash_attention_fwd(moved, heads, **kw)
    assert torch.equal(got[0], out) and torch.equal(got[1], lse)
    assert torch.equal(tfa.packed_flash_attention_bwd(moved, do, out, lse,
                                                      heads, **kw), want)


@pytest.mark.cuda
@pytest.mark.parametrize("d,offset,takes", [
    (80, 2, False), (80, 8, True),   # 16-byte copies: 4 bytes off refused
    (90, 2, True), (90, 1, False),   # 4-byte copies: 2 bytes off refused
    (77, 1, True)])                  # an odd D: 2-byte loads, any offset
def test_split_head_128_tile_copy_grain_follows_the_head_dim(cuda, d, offset,
                                                             takes):
    """Rows 2-6 run D 65-127 in the 128 tile with the PaddedStrided layout's
    copies (`GroupPad`): a bf16 operand `offset` elements into a buffer gives
    the aligned call's bits where the grain allows it, and is refused as
    misaligned where it does not."""
    b, h, s, bf16 = 2, 3, 37, torch.bfloat16
    n = b * h * s * d

    def at(off, seed):
        buf = torch.zeros(n + off, device=cuda, dtype=bf16)
        buf[off:] = torch.from_numpy(_randn(seed, n)).to(cuda, bf16)
        return buf[off:].view(b, h, s, d)

    aligned = [at(0, 80 + i) for i in range(4)]
    moved = [at(offset, 80 + i) for i in range(4)]
    mask = torch.from_numpy(_masks(b, s)).to(cuda)
    kw = dict(dropout_rate=0.1, seed=5)
    out, lse = tfa.flash_dropout_attention_fwd(*aligned[:3], **kw)
    calls = (
        lambda q, k, v, do: tfa.flash_attention_fwd(q, k, v),
        lambda q, k, v, do: tfa.flash_dropout_attention_fwd(q, k, v, **kw),
        lambda q, k, v, do: tfa.flash_dropout_attention_bwd(
            q, k, v, do, out, lse, **kw),
        lambda q, k, v, do: tfa.flash_attention_large_fwd(q, k, v,
                                                          kv_mask=mask),
        lambda q, k, v, do: tfa.flash_attention_bwd(q, k, v, out, lse, do))
    for fn in calls:
        if not takes:
            with pytest.raises(RuntimeError, match="misaligned"):
                fn(*moved)
            continue
        want, got = fn(*aligned), fn(*moved)
        assert all(torch.equal(a, g) for a, g in zip(want, got))


# Rows 1-7 above head dim 128 (csrc/attention_wide_tile.cuh: D split across
# the grid in chunks): every wrapper against its plain version, by kernel
# name, at D 129 and 200 (an odd D: 2-byte copies; an even one: 4-byte), 160
# (a multiple of 8 not of 128: 16-byte copies, a half-empty last chunk), 256
# (ViT-B/16's widths at 3 heads) and 512. Forward outputs NaN-filled, reruns
# bit-equal, at the limits of the D <= 128 kernels.
_WIDE_DIMS = [129, 160, 200, 256, 512]


def _wide(name, dtype):
    """The wide kernel of ``name`` (the bf16 one's stem) in ``dtype``."""
    return name.replace("_mma", "" if dtype == torch.float32 else "_mma") \
        .replace("_kernel", "_wide_kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", _WIDE_DIMS)
def test_wide_packed_kernels_match_plain(cuda, dtype, rate, d):
    """Rows 1 and 7 above D 128: out, lse and dqkv against the plain
    versions; at rate 0.1 the next seed's mask is another function, so the
    mask every chunk block draws is the plain version's."""
    from vision_transformers_tpu_torch.ops import _build

    b, s, heads = 2, 70, 2
    qkv = torch.from_numpy(_randn(90, b, s, 3 * heads * d)).to(cuda, dtype)
    do = torch.from_numpy(_randn(91, b, s, heads * d)).to(cuda, dtype)
    kw = dict(dropout_rate=rate, seed=7, kv_valid=66)
    _build.reset_launched()
    out, lse = tfa.packed_flash_attention_fwd(
        qkv, heads, **kw, **_nan_filled(b, s, heads, d, dtype, cuda))
    dqkv = tfa.packed_flash_attention_bwd(
        qkv, do, out, lse, heads, **kw,
        dqkv=torch.full_like(qkv, float("nan")))
    torch.cuda.synchronize()
    assert _build.launched() == {
        _wide(n, dtype): 1 for n in ("packed_fwd_mma_kernel",
                                     "packed_bwd_dq_mma_kernel",
                                     "packed_bwd_dkv_mma_kernel")}
    ref, ref_lse = tfa.packed_flash_attention_reference(qkv, heads, **kw)
    assert not bool(out.isnan().any()) and not bool(dqkv.isnan().any())
    assert (out.float() - ref.float()).abs().max().item() <= _KERNEL_TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    dref = tfa.packed_flash_attention_bwd_reference(qkv, do, out, lse, heads,
                                                    **kw)
    tol = _MMA_GRAD_TOL if dtype == torch.bfloat16 else None
    assert _grad_close(dqkv, dref, dtype, tol)
    again = tfa.packed_flash_attention_fwd(qkv, heads, **kw)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    assert torch.equal(tfa.packed_flash_attention_bwd(qkv, do, out, lse,
                                                      heads, **kw), dqkv)
    if rate > 0:
        other, _ = tfa.packed_flash_attention_reference(
            qkv, heads, dropout_rate=rate, seed=8, kv_valid=66)
        assert (out.float() - other.float()).abs().max().item() > \
            _KERNEL_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", _WIDE_DIMS)
def test_wide_split_head_kernels_match_plain(cuda, dtype, d):
    """Rows 2 (a bias), 3 (a key-padding mask) and 5/6 (dropout 0.1 and a
    key mask) above D 128: outputs, lse and gradients against the plain
    versions, each on its wide kernel."""
    from vision_transformers_tpu_torch.ops import _build

    b, h, sq, sk, kv_valid = 2, 2, 70, 90, 85
    q = torch.from_numpy(_randn(92, b, h, sq, d)).to(cuda, dtype)
    k = torch.from_numpy(_randn(93, b, h, sk, d)).to(cuda, dtype)
    v = torch.from_numpy(_randn(94, b, h, sk, d)).to(cuda, dtype)
    do = torch.from_numpy(_randn(95, b, h, sq, d)).to(cuda, dtype)
    bias = torch.from_numpy(_randn(96, 1, h, sq, sk)).to(cuda)
    mask = torch.from_numpy(_masks(b, sk)).to(cuda)
    for kind in ("bias", "large"):
        _build.reset_launched()
        if kind == "bias":
            out, lse = tfa.flash_attention_fwd(
                q, k, v, bias, kv_valid=kv_valid,
                out=torch.full_like(q, float("nan")))
            ref, ref_lse = tfa.flash_attention_reference(q, k, v, bias,
                                                         kv_valid=kv_valid)
            want = {_wide("flash_fwd_mma_kernel", dtype): 1}
        else:
            out, lse = tfa.flash_attention_large_fwd(
                q, k, v, kv_mask=mask, kv_valid=kv_valid,
                out=torch.full_like(q, float("nan")))
            ref, ref_lse = tfa.flash_attention_large_reference(
                q, k, v, kv_mask=mask, kv_valid=kv_valid)
            want = {_wide("flash_large_mma_kernel", dtype): 1}
        torch.cuda.synchronize()
        assert _build.launched() == want
        assert not bool(out.isnan().any())
        assert (out.float() - ref.float()).abs().max().item() <= \
            _KERNEL_TOL[dtype]
        assert (lse - ref_lse).abs().max().item() <= 1e-4
    kw = dict(dropout_rate=0.1, seed=99, kv_valid=kv_valid, key_mask=mask)
    _build.reset_launched()
    out, lse = tfa.flash_dropout_attention_fwd(q, k, v, **kw)
    grads = tfa.flash_dropout_attention_bwd(q, k, v, do, out, lse, **kw)
    torch.cuda.synchronize()
    assert _build.launched() == {
        _wide(n, dtype): 1 for n in ("drop_fwd_mma_kernel",
                                     "drop_bwd_dq_mma_kernel",
                                     "drop_bwd_dkv_mma_kernel")}
    ref, ref_lse = tfa.flash_dropout_attention_reference(q, k, v, **kw)
    assert (out.float() - ref.float()).abs().max().item() <= _KERNEL_TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    want = tfa.flash_dropout_attention_bwd_reference(q, k, v, do, out, lse,
                                                     **kw)
    tol = _MMA_GRAD_TOL if dtype == torch.bfloat16 else None
    for g, w in zip(grads, want):
        assert _grad_close(g, w, dtype, tol)
    again = tfa.flash_dropout_attention_bwd(q, k, v, do, out, lse, **kw)
    assert all(torch.equal(a, g) for a, g in zip(again, grads))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", _WIDE_DIMS)
def test_wide_small_s_backward_matches_plain(cuda, dtype, d):
    """Row 4 above D 128 on the wide passes at any S its route (the JAX
    score budget) admits: dq, dk, dv against the plain version at S 96, past
    the old shared-memory rule at D 256 and 512 (which admitted S 64 and no
    shape); no shape raises."""
    from vision_transformers_tpu_torch.ops import _build

    s = 96
    assert tfa.flash_bwd_supported(s, s, d)
    q, k, v, do = (torch.from_numpy(_randn(97 + i, 2, 2, s, d)).to(cuda, dtype)
                   for i in range(4))
    out, lse = tfa.flash_attention_fwd(q, k, v, kv_valid=s - 3)
    _build.reset_launched()
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do, kv_valid=s - 3)
    torch.cuda.synchronize()
    assert _build.launched() == {
        _wide(n, dtype): 1 for n in ("flash_bwd_dq_mma_kernel",
                                     "flash_bwd_dkv_mma_kernel")}
    want = tfa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                             kv_valid=s - 3)
    tol = _MMA_GRAD_TOL if dtype == torch.bfloat16 else None
    for g, w in zip(got, want):
        assert _grad_close(g, w, dtype, tol)
    again = tfa.flash_attention_bwd(q, k, v, out, lse, do, kv_valid=s - 3)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


# The window rows 9-13 at dh 1, 2, 4 and 8 (bf16 the tensor-core kernels in
# the 16 tile, the columns past dh zero; fp32 the CUDA-core kernels
# instantiated at dh), at Swin-T's stage shapes with 4× its heads (dh 8) and narrower heads.
_NARROW_WINDOW_SHAPES = [
    # g, n, heads, dh, nW'
    (256, 49, 12, 8, 64),   # Swin-T stage 1 at 4× heads, shifted
    (64, 49, 24, 8, 16),    # stage 2
    (10, 49, 96, 8, 1),     # stage 4
    (64, 49, 6, 4, 16),
    (37, 49, 3, 2, 1),      # 6-byte sections: 4-byte copies
    (15, 49, 3, 1, 3),      # 3-element sections: 2-byte loads
]


def _narrow_name(fn, dtype):
    return _WINDOW_ROUTE_NAMES[(fn, dtype)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,n,heads,dh,nwp", _NARROW_WINDOW_SHAPES)
def test_window_kernels_narrow_head_dims_match_plain(cuda, dtype, g, n,
                                                     heads, dh, nwp):
    """Rows 9, 10 and 11 at dh 1-8: the packed and batched forwards and the
    backward against their plain versions (dqkv NaN-filled), by kernel
    name, reruns bit-equal."""
    from vision_transformers_tpu_torch.ops import _build

    qkv, bias = _window_inputs(cuda, dtype, g, n, heads, dh, nwp)
    for fn in ("window_packed_attention", "window_batched_attention"):
        _build.reset_launched()
        out = getattr(tfa, fn)(qkv, bias, heads)
        torch.cuda.synchronize()
        assert _build.launched() == {_narrow_name(fn, dtype): 1}
        ref = tfa.window_attention_reference(qkv, bias, heads)
        assert _window_close(out, ref, dtype)
        assert torch.equal(getattr(tfa, fn)(qkv, bias, heads), out)
    do = torch.from_numpy(_randn(48, g, n, heads * dh)).to(cuda, dtype)
    ref, ref_db = tfa.window_attention_bwd_reference(qkv, bias, do, heads)
    _build.reset_launched()
    got, got_db = tfa.window_attention_bwd(
        qkv, bias, do, heads, dqkv=torch.full_like(qkv, float("nan")))
    torch.cuda.synchronize()
    assert _build.launched() == {
        _narrow_name("window_attention_bwd", dtype): 1}
    assert not bool(torch.isnan(got.float()).any())
    tol = _WINDOW_GRAD_TOL if dtype == torch.bfloat16 else None
    assert _grad_close(got, ref, dtype, tol)
    again, again_db = tfa.window_attention_bwd(qkv, bias, do, heads)
    assert torch.equal(got, again)
    if bias is not None:
        assert _grad_close(got_db, ref_db, dtype, tol)
        assert torch.equal(got_db, again_db)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,shift,heads,dh", [
    (56, 3, 12, 8),   # Swin-T stage 1 at 4× heads: the slab kernel
    (28, 3, 24, 8),   # stage 2: the flat one
    (28, 3, 6, 2), (56, 0, 3, 1), (28, 3, 6, 4)])
def test_fused_window_kernels_narrow_head_dims_match_plain(cuda, dtype, hw,
                                                           shift, heads, dh):
    """Rows 12 and 13 at dh 1-8 on Swin-T's maps (window 7, per-window bias
    where shifted): each plan the map has into a NaN-filled out, by kernel
    name, reruns bit-equal."""
    from vision_transformers_tpu_torch.ops import _build

    b, win = 2, 7
    nwp = (hw // win) ** 2 if shift else 1
    qkv = torch.from_numpy(_randn(42, b, hw, hw, 3 * heads * dh)).to(cuda,
                                                                   dtype)
    bias = torch.from_numpy(_randn(43, nwp, heads, 49, 49)).to(cuda)
    ref = tfa.window_fused_reference(qkv, bias, heads, (win, win),
                                     (shift, shift))
    for plan in _fused_plans(b, hw, hw, win, heads, dh, nwp):
        kind = plan[0]
        out = torch.full(ref.shape, float("nan"), device=cuda, dtype=dtype)
        _build.reset_launched()
        tfa.fused_window_attention(qkv, bias, heads, (win, win),
                                   (shift, shift), plan=plan, out=out)
        torch.cuda.synchronize()
        assert _build.launched() == {_narrow_name(
            f"window_fused_{kind}_attention", dtype): 1}
        assert not bool(torch.isnan(out.float()).any())
        assert _window_close(out, ref, dtype)
        assert torch.equal(tfa.fused_window_attention(
            qkv, bias, heads, (win, win), (shift, shift), plan=plan), out)
