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
# probabilities to bf16 before PV (as the TPU kernel does); the packed and
# dropout kernels keep them fp32, and the split-head kernel on the tensor
# cores rounds them before it normalises, not after; plus one rounding of
# the output, one bf16 step of 1.6e-2 at |out| 2-4 (which the tensor-core
# kernel reaches at D 64 with a bias).
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


# Shapes of the split-head kernels: (Sq, Sk, kv_valid, D). Sk 49 is below
# one 64-key tile of the bf16 kernels, Sq 1000 a ragged last query tile.
_SPLIT_SHAPES = [(49, 49, None, 32), (100, 25, None, 32), (70, 70, 60, 32),
                 (1000, 49, None, 64), (1000, 130, 120, 16),
                 (100, 100, None, 64)]


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
# fp32: summation order and expf against torch.exp. bf16: the plain versions
# round the probabilities and ds to bf16 before their products (as the TPU
# kernels do) and the kernels keep them fp32, plus one rounding of the result.
_GRAD_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
# The bf16 split-head backward (row 6) runs on the tensor cores and rounds pd
# and ds to bf16 before their products, as its plain version does: what is
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
@pytest.mark.parametrize("sq,sk,kv_valid,masked,d", [
    (49, 49, None, False, 32), (100, 25, None, False, 32),
    (70, 70, 60, True, 32), (257, 257, None, True, 32),
    (1000, 49, None, False, 64), (1000, 130, 120, True, 16),
    (130, 1000, 990, True, 64)])
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
    assert (out.float() - ref.float()).abs().max().item() <= _KERNEL_TOL[dtype]
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
# against torch.exp on outputs of magnitude <= 4. bf16: the plain version
# rounds the normalised probabilities to bf16 before PV (as the TPU kernels
# do) and the kernels keep them fp32, plus one rounding of the output.
_WINDOW_TOL = {torch.float32: 5e-6, torch.bfloat16: 2e-2}

_WINDOW_SHAPES = [
    # g, n, heads, dh, nW'
    (256, 49, 3, 32, 64),   # Swin-T stage 1, shifted
    (147, 64, 3, 32, 49),   # SwinV2-T stage 1: nW' = 49 against any grouping
    (64, 49, 6, 32, 16),    # Swin-T stage 2
    (10, 49, 24, 32, 1),    # Swin-T stage 4: few windows, many heads
    (37, 16, 2, 16, 1),     # CIFAR window, ragged last block
    (7, 128, 1, 64, 7),     # the largest window and head dim
    (5, 49, 3, 32, 0),      # no bias
]


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
    assert (out.float() - ref.float()).abs().max().item() <= _WINDOW_TOL[dtype]


@pytest.mark.cuda
def test_window_masks_do_not_overflow(cuda):
    """A shift mask of -100 and a pad mask of -1e9 on top of the bias, in
    bf16: finite outputs equal to the plain version's."""
    g, n, heads, dh = 8, 49, 3, 32
    qkv, bias = _window_inputs(cuda, torch.bfloat16, g, n, heads, dh, 4)
    bias[1, :, :, 40:] = -100.0
    bias[2, :, :, 25:] += -1e9
    bias[3, :, 10:, :10] = -100.0
    ref = tfa.window_attention_reference(qkv, bias, heads)
    for fn in (tfa.window_packed_attention, tfa.window_batched_attention):
        out = fn(qkv, bias, heads)
        assert bool(torch.isfinite(out.float()).all())
        assert (out.float() - ref.float()).abs().max().item() <= 2e-2


_FUSED_SHAPES = [
    # b, hp, wp, window, shift, heads, dh, per-window bias
    (2, 56, 56, 7, (3, 3), 3, 32, True),    # Swin-T stage 1: slab and flat
    (3, 28, 28, 7, (3, 3), 6, 32, True),    # stage 2 (flat): row and column wrap
    (2, 14, 14, 7, (3, 3), 12, 32, True),   # stage 3 (flat)
    (2, 14, 14, 7, (0, 0), 12, 32, False),  # stage 3 unshifted
    (3, 16, 8, 4, (1, 3), 2, 16, True),     # non-square, CIFAR window
    (1, 32, 32, 8, (4, 4), 2, 64, False),   # window 8, dh 64, shift without a mask
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
    bias = torch.from_numpy(_randn(43, nwp, heads, n, n)).to(cuda)
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
    assert (out.float() - ref.float()).abs().max().item() <= _WINDOW_TOL[dtype]


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
    a forward-only convenience."""
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
    with pytest.raises(ValueError, match="head dim"):
        tfa.window_packed_attention(torch.zeros(4, 16, 3 * 2 * 8, device=cuda),
                                    None, 2)


# The window backward against its plain version. dqkv as _GRAD_TOL. dbias sums
# G/nW' windows of ds rounded to the compute dtype on both sides; the kernel's
# ds differs from the plain one by fp32 summation order before that rounding,
# so a few terms land on the other side of a bf16 rounding: relative to the
# largest reference element.
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
    assert _grad_close(got, ref, dtype)
    assert torch.equal(got, again)  # no atomics: equal bits
    if bias is None:
        assert got_db is None and ref_db is None
    else:
        assert got_db.shape == bias.shape and got_db.dtype == bias.dtype
        assert _grad_close(got_db, ref_db, dtype)
        assert torch.equal(got_db, again_db)
        no_db = tfa.window_attention_bwd(qkv, bias, do, heads,
                                         need_dbias=False)
        assert no_db[1] is None and torch.equal(no_db[0], got)


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
    """Three steps over leaves on both sides of 65 536 elements, one with a
    ragged last vector and one not 16-byte aligned: in place, and within
    1e-6 of the plain version (the kernel rounds each operation on its own,
    in the plain version's order)."""
    from vision_transformers_tpu_torch.ops import fused_adam as tadam

    shapes = [(300, 300), (65536,), (65539,), (131, 1001), (1000,), (7, 9)]
    rng = np.random.RandomState(55)
    make = lambda scale: [  # noqa: E731
        torch.from_numpy((scale * rng.randn(*s)).astype(np.float32)).to(cuda)
        for s in shapes]
    params, mu, nu = make(1.0), make(0.0), make(0.0)
    # a large leaf that starts 4 bytes past a 16-byte boundary
    odd = torch.from_numpy(rng.randn(70001).astype(np.float32)).to(cuda)[1:]
    params.append(odd)
    mu.append(torch.zeros_like(odd))
    nu.append(torch.zeros_like(odd))
    ref = [[t.clone() for t in group] for group in (params, mu, nu)]
    ptrs = [t.data_ptr() for group in (params, mu, nu) for t in group]
    large = sum(p.numel() >= tadam._MIN_FUSED_SIZE for p in params)
    tfa.reset_launch_counts()
    for step in range(1, 4):
        grads = [torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
                 .to(cuda) for p in params]
        tadam.fused_adam_update(params, mu, nu, grads, step, 1e-3,
                                weight_decay=weight_decay)
        s = tadam.adam_scalars(step, 1e-3, weight_decay=weight_decay)
        for p, m, v, g in zip(*ref, grads):
            tadam.fused_adam_reference(p, m, v, g, s)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["fused_adam"] == 3 * large and large == 5
    assert ptrs == [t.data_ptr() for group in (params, mu, nu) for t in group]
    for got, want in zip((params, mu, nu), ref):
        for a, r in zip(got, want):
            assert (a - r).abs().max().item() <= 1e-6


@pytest.mark.cuda
def test_unported_paths_raise_on_cuda(cuda):
    """What the kernels refuse on the card: a bias on the streaming route
    (a key-padding mask, or Sq·Sk > 1.5 M), an unsupported head dim, and a
    small-S backward whose group does not fit a block's shared memory. A
    key-padding mask at rate 0 and a large bias-free S now launch the
    streaming kernel."""
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
    with pytest.raises(ValueError, match="head dim"):
        tfa.packed_flash_attention(torch.zeros(1, 4, 3 * 2 * 8, device=cuda), 2)
    wide = torch.zeros(1, 1, 4, 64, device=cuda)
    long_k = torch.zeros(1, 1, 1000, 64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        tfa.flash_attention_bwd(wide, long_k, long_k, wide,
                                torch.zeros(1, 1, 4, device=cuda), wide)
    x, rows, w = _block_inputs(cuda, torch.float32, 1, 8, 40)
    with pytest.raises(ValueError, match="head dim"):   # dh 20
        tfa.fused_attention_block(x, *rows[:2], w[0], rows[2], w[1], rows[3],
                                  2)
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
    (3, 3, 70, 45, 16, 40, True)])
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
    assert (out.float() - ref.float()).abs().max().item() <= _KERNEL_TOL[dtype]
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
    (1, 2, 33, 300, 32, 290)])
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
    for g, w, r in zip(got, want, row6):
        assert not bool(torch.isnan(g.float()).any())  # every element written
        assert _grad_close(g, w, dtype)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,n,activation,with_bias", [
    (394, 768, 2304, None, True),         # [ln_1 + QKV], ViT-B, 2 images
    (394, 768, 3072, "gelu_tanh", True),  # [ln_2 + fc1 + GELU]
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
