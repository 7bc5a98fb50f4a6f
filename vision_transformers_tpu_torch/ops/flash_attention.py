"""Attention kernels for Hopper, forward and backward, each beside its plain
version.

Counterpart of ``vision_transformers_tpu/ops/flash_attention.py``. Five of
its TPU kernels are ported, as CUDA C++ in ``csrc/``:

- ``packed_flash_attention`` (``csrc/packed_attention.cu``) replaces
  ``_packed_fwd_kernel`` and ``_packed_bwd_kernel``: self attention read in
  place from the packed (B, S, 3·H·dh) QKV projection, with in-kernel
  probability dropout; the backward recomputes the probabilities from
  (qkv, lse), replays the dropout mask and writes the packed dqkv.
- ``flash_dropout_attention`` (``csrc/dropout_attention.cu``) replaces
  ``_drop_fwd_kernel`` and ``_drop_bwd_kernel``: split-head (B, H, S, D)
  attention with dropout, a key-padding mask and Sq != Sk.
- ``flash_attention`` (``csrc/flash_attention.cu``) replaces
  ``_attn_kernel``: split-head attention with an additive bias. Without a
  bias its backward is the ``flash_dropout_attention`` backward kernel at
  rate 0; with a bias it is plain PyTorch (dq, dk, dv and dbias), as the JAX
  package computes that case outside any kernel.

Each wrapper takes its plain PyTorch version (``*_reference``) only for a
tensor on the CPU. For a CUDA tensor it launches its kernel or raises: there
is no fallback. ``LAUNCHES`` counts the kernel launches of each wrapper, so
a run can show that its path went through the kernels.

Dropout masks come from one counter-based generator, Philox 4x32-10
(``philox_4x32``; ``csrc/philox.cuh`` is the same function for the kernels).
The keep bit of one probability is a function of (seed, batch·H + head,
query row, key column) and of nothing else — not of a tile, a block or a
launch shape — so the plain versions draw the very mask the kernels draw,
and a backward replays its forward's mask from the seed alone.

Still raising ``NotImplementedError`` on CUDA: the runtime ``kv_mask`` at
rate 0 and the large-S streaming forward (``_large_kernel``, for
Sq·Sk > 1.5 M).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

# The TPU kernels' finite mask value (flash_attention.py:44), also used by
# the CUDA kernels (csrc/attention_tile.cuh).
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# Score elements (Sq·Sk) above which the JAX package switches its bias-taking
# forward to the streaming kernel (_SMALL_S_LIMIT), which is not ported yet.
MAX_SCORE_ELEMS = 1_500_000

# Head dims the CUDA kernels are instantiated for.
KERNEL_HEAD_DIMS = (16, 32, 64)

# kernel name -> launches since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {
    "packed_attention": 0, "flash_attention": 0, "packed_attention_bwd": 0,
    "dropout_attention_fwd": 0, "dropout_attention_bwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kv_valid(kv_valid: Optional[int], s_k: int) -> int:
    kv_valid = s_k if kv_valid is None else min(int(kv_valid), s_k)
    if kv_valid < 1:
        raise ValueError(f"kv_valid must be >= 1, got {kv_valid}")
    return kv_valid


def _mask_keys(s: torch.Tensor, kv_valid: int) -> torch.Tensor:
    """Scores of keys >= kv_valid set to DEFAULT_MASK_VALUE (last axis)."""
    if kv_valid >= s.shape[-1]:
        return s
    col = torch.arange(s.shape[-1], device=s.device) < kv_valid
    return torch.where(col, s, torch.full_like(s, DEFAULT_MASK_VALUE))


def _check_cuda_operand(name: str, t: torch.Tensor, dtype: torch.dtype,
                        head_dim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"{name}: dtype {t.dtype}; the kernel takes float32 or bfloat16, "
            "the same for every operand")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"head dim {head_dim} not supported by the CUDA kernel "
            f"(supported: {KERNEL_HEAD_DIMS})")


def _check_same_device(ref: torch.Tensor, **others: torch.Tensor) -> None:
    for name, t in others.items():
        if t.device != ref.device:
            raise ValueError(f"{name} on {t.device}, expected {ref.device}")


# ---------------------------------------------------------------------------
# Dropout: Philox 4x32-10, one keep bit per (seed, group, row, column)

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _mul_hi_lo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the 64-bit product a·b, for a 32-bit
    constant a and int64 tensors holding 32-bit values; b is split in 16-bit
    halves so that no intermediate leaves the int64 range."""
    lo16 = (b & 0xFFFF) * a
    hi16 = (b >> 16) * a
    hi = (hi16 + (lo16 >> 16)) >> 16
    lo = (lo16 + ((hi16 & 0xFFFF) << 16)) & _U32
    return hi, lo


def philox_4x32(c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
                c3: torch.Tensor, key0: int, key1: int
                ) -> Tuple[torch.Tensor, ...]:
    """Philox 4x32 with 10 rounds on int64 tensors that hold 32-bit words:
    counter (c0, c1, c2, c3), key (key0, key1) → four words of random bits.
    Matches the Random123 known-answer vectors."""
    k0, k1 = key0 & _U32, key1 & _U32
    for _ in range(10):
        hi0, lo0 = _mul_hi_lo(_PHILOX_M0, c0)
        hi1, lo1 = _mul_hi_lo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W0) & _U32, (k1 + _PHILOX_W1) & _U32
    return c0, c1, c2, c3


def dropout_threshold(rate: float) -> int:
    """A probability is kept when its 32 random bits, read unsigned, are
    >= this (the TPU kernels' ``_dropout_keep`` rule)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def dropout_keep_mask(seed: int, rate: float, groups: int, s_q: int,
                      s_k: int, device=None) -> torch.Tensor:
    """Bool (groups, Sq, Sk), True = keep; group g = batch·H + head.

    Element (g, i, j) is word j % 4 of Philox(counter = (j // 4, i, g, 0),
    key = (seed low word, seed high word)) compared with the threshold."""
    seed = int(seed) & (2 ** 64 - 1)
    quads = -(-s_k // 4)
    shape = (groups, s_q, quads)
    i64 = dict(dtype=torch.int64, device=device)
    c0 = torch.arange(quads, **i64).expand(shape)
    c1 = torch.arange(s_q, **i64)[:, None].expand(shape)
    c2 = torch.arange(groups, **i64)[:, None, None].expand(shape)
    words = philox_4x32(c0, c1, c2, torch.zeros((), **i64), seed & _U32,
                        seed >> 32)
    bits = torch.stack(words, dim=-1).reshape(groups, s_q, quads * 4)
    return bits[..., :s_k] >= dropout_threshold(rate)


def _dropout_args(rate: float, seed: Optional[int]) -> Tuple[float, int]:
    rate = float(rate)
    dropout_threshold(rate)  # range check
    if rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    return rate, 0 if seed is None else int(seed) & (2 ** 64 - 1)


def _c_dropout(rate: float, seed: int):
    """(threshold, 1/(1-rate), seed) as the C entries take them."""
    return dropout_threshold(rate), 1.0 / (1.0 - rate), seed


# ---------------------------------------------------------------------------
# Packed-QKV attention (replaces _packed_fwd_kernel, flash_attention.py:796,
# and _packed_bwd_kernel, :833)

_PACKED_VMEM_TARGET = 13 * 1024 * 1024


def packed_flash_supported(b: int, s: int, three_hd: int,
                           itemsize: int) -> bool:
    """The JAX package's routing test (flash_attention.py:764), with the same
    numbers, so both packages take the packed branch for the same shapes:
    true if one image's packed working set fits the TPU's VMEM budget (at
    ViT-B/16, S = 197 passes and S = 1025 goes to the split-head kernel)."""
    hd = three_hd // 3
    per_image = 2 * (s * three_hd + s * hd) * itemsize + 3 * s * s * 4
    return per_image <= _PACKED_VMEM_TARGET


def _packed_dims(qkv: torch.Tensor, heads: int, scale: Optional[float],
                 kv_valid: Optional[int]):
    if qkv.ndim != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError(
            f"qkv must be (B, S, 3·H·dh) with H={heads}, got {tuple(qkv.shape)}")
    b, s, three_hd = qkv.shape
    hd = three_hd // 3
    dh = hd // heads
    scale = dh ** -0.5 if scale is None else float(scale)
    return b, s, hd, dh, scale, _kv_valid(kv_valid, s)


def _split_packed(qkv: torch.Tensor, heads: int):
    """(B, S, 3·H·dh) → q, k, v views of shape (B, H, S, dh)."""
    b, s, three_hd = qkv.shape
    hd = three_hd // 3
    return tuple(t.reshape(b, s, heads, hd // heads).transpose(1, 2)
                 for t in qkv.split(hd, dim=-1))


def packed_flash_attention_reference(
        qkv: torch.Tensor, heads: int, scale: Optional[float] = None,
        dropout_rate: float = 0.0, seed: Optional[int] = None,
        kv_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the packed forward → (out (B, S, H·dh) in
    qkv's dtype, lse (B, S, H) fp32).

    Follows the TPU kernel's arithmetic: fp32 scores and softmax
    statistics, dropout on the unnormalised exp (scaled by 1/(1-rate)), the
    exp rounded to the value dtype before the PV product, the output divided
    by the undropped row sum after it; lse is of the undropped softmax.
    """
    b, s, hd, dh, scale, kv_valid = _packed_dims(qkv, heads, scale, kv_valid)
    rate, seed = _dropout_args(dropout_rate, seed)
    q, k, v = _split_packed(qkv, heads)
    sc = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    sc = _mask_keys(sc, kv_valid)
    m = sc.amax(dim=-1, keepdim=True)
    e = torch.exp(sc - m)
    denom = e.sum(dim=-1, keepdim=True)
    if rate > 0.0:
        keep = dropout_keep_mask(seed, rate, b * heads, s, s, qkv.device)
        e = torch.where(keep.view(b, heads, s, s), e,
                        torch.zeros_like(e)) * (1.0 / (1.0 - rate))
    o = torch.matmul(e.to(v.dtype).float(), v.float()) / denom
    out = o.transpose(1, 2).reshape(b, s, hd).to(qkv.dtype)
    lse = (m + torch.log(denom)).squeeze(-1).transpose(1, 2)
    return out, lse.contiguous()


def packed_flash_attention_bwd_reference(
        qkv: torch.Tensor, do: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, heads: int, scale: Optional[float] = None,
        dropout_rate: float = 0.0, seed: Optional[int] = None,
        kv_valid: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the packed backward → dqkv (B, S, 3·H·dh)
    in qkv's dtype, written out from the TPU kernel's formulas
    (flash_attention.py:858-887), not autograd of the forward:

    p = exp(s − lse), δ = rowsum(do ⊙ out), dp = do·vᵀ; with dropout
    pd = keep ⊙ p/(1−r) and dp ← keep ⊙ dp/(1−r); dv = pdᵀ·do,
    ds = p ⊙ (dp − δ)·scale, dq = ds·k, dk = dsᵀ·q. pd and ds are rounded
    to the value dtype before their products, as the TPU kernel does.
    """
    b, s, hd, dh, scale, kv_valid = _packed_dims(qkv, heads, scale, kv_valid)
    rate, seed = _dropout_args(dropout_rate, seed)
    q, k, v = _split_packed(qkv, heads)
    heads_of = lambda t: t.reshape(b, s, heads, dh).transpose(1, 2)  # noqa: E731
    keep = None
    if rate > 0.0:
        keep = dropout_keep_mask(seed, rate, b * heads, s, s,
                                 qkv.device).view(b, heads, s, s)
    dq, dk, dv = _attention_bwd_math(
        q, k, v, heads_of(do), heads_of(out),
        lse.transpose(1, 2).unsqueeze(-1), scale, kv_valid, None, keep, rate)
    packed = lambda t: t.transpose(1, 2).reshape(b, s, hd)  # noqa: E731
    return torch.cat([packed(dq), packed(dk), packed(dv)], dim=-1)


def _attention_bwd_math(q, k, v, do, out, lse, scale, kv_valid, mask_add,
                        keep, rate):
    """Shared arithmetic of the two recompute backwards on (B, H, S, D)
    views; lse is (B, H, Sq, 1), mask_add None or additive fp32
    broadcastable to the scores, keep None or the bool dropout mask."""
    dtype = q.dtype
    sc = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    sc = _mask_keys(sc, kv_valid)
    if mask_add is not None:
        sc = sc + mask_add
    p = torch.exp(sc - lse)
    dof = do.float()
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    if keep is not None:
        inv = 1.0 / (1.0 - rate)
        zero = torch.zeros_like(p)
        pd = torch.where(keep, p, zero) * inv
        dp = torch.where(keep, dp, zero) * inv
    else:
        pd = p
    dv = torch.matmul(pd.to(dtype).float().transpose(-1, -2), dof)
    ds = (p * (dp - delta) * scale).to(dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def packed_flash_attention_fwd(
        qkv: torch.Tensor, heads: int, scale: Optional[float] = None,
        dropout_rate: float = 0.0, seed: Optional[int] = None,
        kv_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed forward → (out, fp32 lse (B, S, H)); no autograd graph."""
    b, s, hd, dh, scale, kv_valid = _packed_dims(qkv, heads, scale, kv_valid)
    rate, seed = _dropout_args(dropout_rate, seed)
    if qkv.device.type == "cpu":
        return packed_flash_attention_reference(qkv, heads, scale, rate, seed,
                                                kv_valid)

    from vision_transformers_tpu_torch.ops import _build

    _check_cuda_operand("qkv", qkv, qkv.dtype, dh)
    out = torch.empty(b, s, hd, dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty(b, s, heads, dtype=torch.float32, device=qkv.device)
    lib = _build.load("packed_attention")
    with torch.cuda.device(qkv.device):  # launch on the tensor's card
        rc = lib.packed_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), b, s, heads, dh,
            kv_valid, scale, int(qkv.dtype == torch.bfloat16),
            *_c_dropout(rate, seed),
            torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(lib, "packed_attention", rc)
    LAUNCHES["packed_attention"] += 1
    return out, lse


def packed_flash_attention_bwd(
        qkv: torch.Tensor, do: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, heads: int, scale: Optional[float] = None,
        dropout_rate: float = 0.0, seed: Optional[int] = None,
        kv_valid: Optional[int] = None) -> torch.Tensor:
    """The packed backward: (qkv, do, out, lse) of a forward with the same
    ``scale``, ``dropout_rate``, ``seed`` and ``kv_valid`` → dqkv. Every
    element of dqkv is written. Gradients are equal from run to run: dk and
    dv are summed in a fixed order, without atomics."""
    b, s, hd, dh, scale, kv_valid = _packed_dims(qkv, heads, scale, kv_valid)
    rate, seed = _dropout_args(dropout_rate, seed)
    if do.shape != (b, s, hd) or out.shape != (b, s, hd) \
            or lse.shape != (b, s, heads):
        raise ValueError(
            f"do and out must be {(b, s, hd)} and lse {(b, s, heads)}; got "
            f"{tuple(do.shape)}, {tuple(out.shape)}, {tuple(lse.shape)}")
    if qkv.device.type == "cpu":
        return packed_flash_attention_bwd_reference(
            qkv, do, out, lse, heads, scale, rate, seed, kv_valid)

    from vision_transformers_tpu_torch.ops import _build

    do = do.contiguous()  # arrives as a view when the caller reshaped out
    for name, t in (("qkv", qkv), ("do", do), ("out", out)):
        _check_cuda_operand(name, t, qkv.dtype, dh)
    _check_cuda_operand("lse", lse, torch.float32, dh)
    _check_same_device(qkv, do=do, out=out, lse=lse)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty(b * heads * s, dtype=torch.float32, device=qkv.device)
    lib = _build.load("packed_attention")
    with torch.cuda.device(qkv.device):
        rc = lib.packed_attention_bwd(
            qkv.data_ptr(), do.data_ptr(), out.data_ptr(), lse.data_ptr(),
            dqkv.data_ptr(), delta.data_ptr(), b, s, heads, dh, kv_valid,
            scale, int(qkv.dtype == torch.bfloat16), *_c_dropout(rate, seed),
            torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(lib, "packed_attention", rc)
    LAUNCHES["packed_attention_bwd"] += 1
    return dqkv


class _PackedFlash(torch.autograd.Function):
    """``_packed_flash``'s custom_vjp (flash_attention.py:1165-1183): saves
    (qkv, out, lse) and the seed; the backward is the packed backward."""

    @staticmethod
    def forward(ctx, qkv, heads, scale, dropout_rate, seed, kv_valid):
        out, lse = packed_flash_attention_fwd(qkv, heads, scale, dropout_rate,
                                              seed, kv_valid)
        ctx.save_for_backward(qkv, out, lse)
        ctx.args = (heads, scale, dropout_rate, seed, kv_valid)
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse = ctx.saved_tensors
        dqkv = packed_flash_attention_bwd(qkv, do, out, lse, *ctx.args)
        return dqkv, None, None, None, None, None


def packed_flash_attention(qkv: torch.Tensor, heads: int,
                           scale: Optional[float] = None,
                           dropout_rate: float = 0.0,
                           seed: Optional[int] = None,
                           kv_valid: Optional[int] = None) -> torch.Tensor:
    """Self attention straight off the packed QKV projection.

    qkv: (B, S, 3·H·dh) laid out [q | k | v] along the last axis (torch
    packed-MHA column order). Returns (B, S, H·dh). ``dropout_rate`` > 0
    drops probabilities inside the kernel (torch MHA dropout semantics);
    ``seed`` is a host integer of up to 64 bits, and the same seed replays
    the same mask, in the backward too. ``kv_valid`` masks trailing pad
    keys: tokens >= kv_valid receive no attention. Differentiable in qkv.
    """
    return _PackedFlash.apply(qkv, heads, scale, dropout_rate, seed, kv_valid)


# ---------------------------------------------------------------------------
# Split-head attention with dropout (replaces _drop_fwd_kernel,
# flash_attention.py:491, and _drop_bwd_kernel, :525)


def _split_dims(q, k, v, scale, kv_valid, key_mask=None):
    if q.ndim != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(
            "q must be (B, H, Sq, D) and k, v (B, H, Sk, D); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    if key_mask is not None and (key_mask.shape != (b, s_k)
                                 or key_mask.dtype != torch.bool):
        raise ValueError(f"key_mask must be bool ({b}, {s_k}), got "
                         f"{key_mask.dtype} {tuple(key_mask.shape)}")
    scale = d ** -0.5 if scale is None else float(scale)
    return b, h, s_q, s_k, d, scale, _kv_valid(kv_valid, s_k)


def _key_mask_add(key_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Bool (B, Sk), True = attend → additive fp32 (B, Sk): 0 or
    DEFAULT_MASK_VALUE (flash_attention.py:735-739)."""
    if key_mask is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=key_mask.device)
    return torch.where(key_mask, zero, zero + DEFAULT_MASK_VALUE).contiguous()


def flash_dropout_attention_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        dropout_rate: float, seed: Optional[int],
        scale: Optional[float] = None, kv_valid: Optional[int] = None,
        key_mask: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dropout forward → (out (B, H, Sq, D),
    lse (B, H, Sq) fp32), in ``_drop_fwd_kernel``'s arithmetic: ``kv_valid``
    first, then the additive key mask, dropout on the unnormalised exp,
    probabilities normalised by the undropped sum and rounded to the value
    dtype before PV."""
    b, h, s_q, s_k, d, scale, kv_valid = _split_dims(q, k, v, scale, kv_valid,
                                                     key_mask)
    rate, seed = _dropout_args(dropout_rate, seed)
    sc = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    sc = _mask_keys(sc, kv_valid)
    mask_add = _key_mask_add(key_mask)
    if mask_add is not None:
        sc = sc + mask_add[:, None, None, :]
    m = sc.amax(dim=-1, keepdim=True)
    e = torch.exp(sc - m)
    denom = e.sum(dim=-1, keepdim=True)
    if rate > 0.0:
        keep = dropout_keep_mask(seed, rate, b * h, s_q, s_k, q.device)
        e = torch.where(keep.view(b, h, s_q, s_k), e,
                        torch.zeros_like(e)) * (1.0 / (1.0 - rate))
    p = e * (1.0 / denom)
    out = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
    return out, (m + torch.log(denom)).squeeze(-1)


def flash_dropout_attention_bwd_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
        out: torch.Tensor, lse: torch.Tensor, *, dropout_rate: float,
        seed: Optional[int], scale: Optional[float] = None,
        kv_valid: Optional[int] = None,
        key_mask: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dropout backward → (dq, dk, dv), from
    ``_drop_bwd_kernel``'s formulas (flash_attention.py:555-583); lse is
    (B, H, Sq)."""
    b, h, s_q, s_k, d, scale, kv_valid = _split_dims(q, k, v, scale, kv_valid,
                                                     key_mask)
    rate, seed = _dropout_args(dropout_rate, seed)
    keep = None
    if rate > 0.0:
        keep = dropout_keep_mask(seed, rate, b * h, s_q, s_k,
                                 q.device).view(b, h, s_q, s_k)
    mask_add = _key_mask_add(key_mask)
    if mask_add is not None:
        mask_add = mask_add[:, None, None, :]
    return _attention_bwd_math(q, k, v, do, out, lse.unsqueeze(-1), scale,
                               kv_valid, mask_add, keep, rate)


def flash_dropout_attention_fwd(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        dropout_rate: float, seed: Optional[int],
        scale: Optional[float] = None, kv_valid: Optional[int] = None,
        key_mask: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dropout forward → (out, fp32 lse (B, H, Sq)); no autograd graph."""
    b, h, s_q, s_k, d, scale, kv_valid = _split_dims(q, k, v, scale, kv_valid,
                                                     key_mask)
    rate, seed = _dropout_args(dropout_rate, seed)
    if q.device.type == "cpu":
        return flash_dropout_attention_reference(
            q, k, v, dropout_rate=rate, seed=seed, scale=scale,
            kv_valid=kv_valid, key_mask=key_mask)

    from vision_transformers_tpu_torch.ops import _build

    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda_operand(name, t, q.dtype, d)
    mask_add = _key_mask_add(key_mask)
    _check_same_device(q, k=k, v=v,
                       **({} if mask_add is None else {"key_mask": mask_add}))
    out = torch.empty_like(q)
    lse = torch.empty(b, h, s_q, dtype=torch.float32, device=q.device)
    lib = _build.load("dropout_attention")
    with torch.cuda.device(q.device):
        rc = lib.dropout_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask_add is None else mask_add.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b * h, h, s_q, s_k, d, kv_valid,
            scale, int(q.dtype == torch.bfloat16), *_c_dropout(rate, seed),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "dropout_attention", rc)
    LAUNCHES["dropout_attention_fwd"] += 1
    return out, lse


def flash_dropout_attention_bwd(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
        out: torch.Tensor, lse: torch.Tensor, *, dropout_rate: float,
        seed: Optional[int], scale: Optional[float] = None,
        kv_valid: Optional[int] = None,
        key_mask: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dropout backward → (dq, dk, dv) in the inputs' dtype; dk and dv
    are accumulated in fp32 in a fixed order and cast once. At rate 0 it is
    also the bias-free backward of ``flash_attention``."""
    b, h, s_q, s_k, d, scale, kv_valid = _split_dims(q, k, v, scale, kv_valid,
                                                     key_mask)
    rate, seed = _dropout_args(dropout_rate, seed)
    if do.shape != q.shape or out.shape != q.shape \
            or lse.shape != (b, h, s_q):
        raise ValueError(
            f"do and out must be {tuple(q.shape)} and lse {(b, h, s_q)}; got "
            f"{tuple(do.shape)}, {tuple(out.shape)}, {tuple(lse.shape)}")
    if q.device.type == "cpu":
        return flash_dropout_attention_bwd_reference(
            q, k, v, do, out, lse, dropout_rate=rate, seed=seed, scale=scale,
            kv_valid=kv_valid, key_mask=key_mask)

    from vision_transformers_tpu_torch.ops import _build

    do = do.contiguous()  # arrives as a view of the caller's transpose
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do), ("out", out)):
        _check_cuda_operand(name, t, q.dtype, d)
    _check_cuda_operand("lse", lse, torch.float32, d)
    mask_add = _key_mask_add(key_mask)
    _check_same_device(q, k=k, v=v, do=do, out=out, lse=lse,
                       **({} if mask_add is None else {"key_mask": mask_add}))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(b * h * s_q, dtype=torch.float32, device=q.device)
    lib = _build.load("dropout_attention")
    with torch.cuda.device(q.device):
        rc = lib.dropout_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask_add is None else mask_add.data_ptr(),
            do.data_ptr(), out.data_ptr(), lse.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), b * h, h, s_q,
            s_k, d, kv_valid, scale, int(q.dtype == torch.bfloat16),
            *_c_dropout(rate, seed),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "dropout_attention", rc)
    LAUNCHES["dropout_attention_bwd"] += 1
    return dq, dk, dv


class _FlashDropout(torch.autograd.Function):
    """``_flash_dropout_attention``'s custom_vjp (flash_attention.py:686-713)."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, dropout_rate, seed, scale, kv_valid):
        kw = dict(dropout_rate=dropout_rate, seed=seed, scale=scale,
                  kv_valid=kv_valid, key_mask=key_mask)
        out, lse = flash_dropout_attention_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_dropout_attention_bwd(q, k, v, do, out, lse,
                                                 **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_dropout_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, dropout_rate: float,
                            seed: Optional[int],
                            scale: Optional[float] = None,
                            kv_valid: Optional[int] = None,
                            key_mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Split-head attention with in-kernel probability dropout.

    q: (B, H, Sq, D); k, v: (B, H, Sk, D). ``seed``: a host integer of up
    to 64 bits; the same seed replays the same mask, in the backward too.
    ``key_mask``: optional bool (B, Sk), True = attend, folded in as an
    additive mask per (batch, key). ``kv_valid`` masks trailing pad keys.
    No bias. Differentiable in q, k and v."""
    return _FlashDropout.apply(q, k, v, key_mask, dropout_rate, seed, scale,
                               kv_valid)


# ---------------------------------------------------------------------------
# Split-head attention with a bias (replaces _attn_kernel,
# flash_attention.py:75; backward as _flash_attention_bwd, :2414)


def _group_bias(bias: torch.Tensor, b: int, h: int, s_q: int, s_k: int
                ) -> torch.Tensor:
    """(bias_b, H, Sq, Sk) → (bias_b·H, Sq, Sk); group g = b·H + h reads
    row g % (bias_b·H), i.e. batch b reads bias[b % bias_b]."""
    if bias.ndim != 4 or bias.shape[1:] != (h, s_q, s_k) or b % bias.shape[0]:
        raise ValueError(
            f"bias must be (n, {h}, {s_q}, {s_k}) with n dividing B={b}, got "
            f"{tuple(bias.shape)}")
    return bias.reshape(bias.shape[0] * h, s_q, s_k)


def _biased_scores(q, k, bias, scale, kv_valid):
    """fp32 scores·scale + bias (broadcast over the batch), then kv_valid."""
    b, h, s_q, _ = q.shape
    s_k = k.shape[2]
    sc = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        bg = _group_bias(bias, b, h, s_q, s_k).float()
        sc = (sc.reshape(b // (bg.shape[0] // h), bg.shape[0], s_q, s_k)
              + bg).reshape(b, h, s_q, s_k)
    return _mask_keys(sc, kv_valid)


def flash_attention_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        bias: Optional[torch.Tensor] = None, *, scale: Optional[float] = None,
        kv_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the split-head kernel → (out (B, H, Sq, D)
    in q's dtype, lse (B, H, Sq) fp32).

    Follows ``_attn_kernel``: fp32 scores·scale + bias, then ``kv_valid``,
    fp32 softmax, probabilities rounded to the value dtype before PV.
    """
    _, _, _, _, _, scale, kv_valid = _split_dims(q, k, v, scale, kv_valid)
    sc = _biased_scores(q, k, bias, scale, kv_valid)
    m = sc.amax(dim=-1, keepdim=True)
    e = torch.exp(sc - m)
    denom = e.sum(dim=-1, keepdim=True)
    p = e * (1.0 / denom)
    out = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
    return out, (m + torch.log(denom)).squeeze(-1)


def flash_attention_bias_bwd(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
        do: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, *,
        scale: float, kv_valid: int):
    """Backward of the biased forward → (dq, dk, dv, dbias), in plain
    PyTorch on any device: the JAX package computes this case outside its
    kernels too (flash_attention.py:2427-2466), in fp32 throughout. dbias
    is ds summed over the batch entries that shared a bias row."""
    b, h, s_q, _ = q.shape
    s_k = k.shape[2]
    p = torch.exp(_biased_scores(q, k, bias, scale, kv_valid)
                  - lse.unsqueeze(-1))
    dof = do.float()
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dbias = ds.reshape(b // bias.shape[0], bias.shape[0], h, s_q,
                       s_k).sum(dim=0).to(bias.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def flash_attention_fwd(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        bias: Optional[torch.Tensor] = None, *, scale: Optional[float] = None,
        kv_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-head forward → (out, fp32 lse (B, H, Sq)); no autograd
    graph."""
    b, h, s_q, s_k, d, scale, kv_valid = _split_dims(q, k, v, scale, kv_valid)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, scale=scale,
                                         kv_valid=kv_valid)
    if s_q * s_k > MAX_SCORE_ELEMS:
        raise NotImplementedError(
            f"Sq·Sk = {s_q * s_k} > {MAX_SCORE_ELEMS}: the streaming kernel "
            "(_large_kernel) is not ported yet (ROADMAP.md, queue 2, row 3)")

    from vision_transformers_tpu_torch.ops import _build

    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda_operand(name, t, q.dtype, d)
    _check_same_device(q, k=k, v=v)
    bias_g = 0
    if bias is not None:
        bias = _group_bias(bias, b, h, s_q, s_k).float().contiguous()
        _check_same_device(q, bias=bias)
        bias_g = bias.shape[0]
    out = torch.empty_like(q)
    lse = torch.empty(b, h, s_q, dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):  # launch on the tensor's card
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b * h, s_q, s_k, d, bias_g,
            kv_valid, scale, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attention", rc)
    LAUNCHES["flash_attention"] += 1
    return out, lse


class _Flash(torch.autograd.Function):
    """``_flash_attention``'s custom_vjp (flash_attention.py:2389-2469)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, kv_valid):
        out, lse = flash_attention_fwd(q, k, v, bias, scale=scale,
                                       kv_valid=kv_valid)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        _, _, _, _, _, ctx.scale, ctx.kv_valid = _split_dims(q, k, v, scale,
                                                             kv_valid)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, lse = ctx.saved_tensors
        if bias is None:
            # the JAX package takes this kernel from Sq·Sk >= 512² + 1 and
            # jnp below; here it serves every size: the same function, and
            # no S×S tensor in device memory
            dq, dk, dv = flash_dropout_attention_bwd(
                q, k, v, do, out, lse, dropout_rate=0.0, seed=None,
                scale=ctx.scale, kv_valid=ctx.kv_valid)
            dbias = None
        else:
            dq, dk, dv, dbias = flash_attention_bias_bwd(
                q, k, v, bias, do, out, lse, scale=ctx.scale,
                kv_valid=ctx.kv_valid)
        return dq, dk, dv, dbias, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *,
                    scale: Optional[float] = None,
                    kv_valid: Optional[int] = None) -> torch.Tensor:
    """Batched attention over (B, H, S, D) inputs.

    ``bias`` is additive, (1 | n | B, H, Sq, Sk) with n dividing B: a leading
    dim smaller than B is broadcast over the batch (batch b reads
    bias[b % n], as Swin's per-window bias needs). ``kv_valid`` masks
    trailing key padding. Sq may differ from Sk. Differentiable in q, k, v
    and bias.
    """
    return _Flash.apply(q, k, v, bias, scale, kv_valid)
