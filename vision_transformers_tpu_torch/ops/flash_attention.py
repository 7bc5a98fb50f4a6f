"""Attention forward kernels for Hopper, each beside its plain version.

Counterpart of ``vision_transformers_tpu/ops/flash_attention.py``. Two of
its TPU kernels are ported so far, as CUDA C++ in ``csrc/``:

- ``packed_flash_attention`` (``csrc/packed_attention.cu``) replaces
  ``_packed_fwd_kernel``: self attention read in place from the packed
  (B, S, 3·H·dh) QKV projection.
- ``flash_attention`` (``csrc/flash_attention.cu``) replaces
  ``_attn_kernel``: split-head (B, H, S, D) attention with an additive bias
  and Sq != Sk.

Each wrapper takes its plain PyTorch version (``*_reference``) only for a
tensor on the CPU. For a CUDA tensor it launches its kernel or raises: there
is no fallback. ``LAUNCHES`` counts the kernel launches of each wrapper, so
a run can show that its path went through the kernels.

Paths of the TPU functions that are not ported yet raise
``NotImplementedError`` on CUDA: in-kernel dropout, the runtime
``kv_mask``, and the large-S streaming kernel (``_large_kernel``, for
Sq·Sk > 1.5 M).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

# The TPU kernels' finite mask value (flash_attention.py:44), also used by
# the CUDA kernels (csrc/attention_tile.cuh).
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# Score elements (Sq·Sk) above which the JAX package switches to its
# streaming kernel (_SMALL_S_LIMIT), which takes no bias; that kernel is
# not ported yet.
MAX_SCORE_ELEMS = 1_500_000

# Head dims the CUDA kernels are instantiated for.
KERNEL_HEAD_DIMS = (16, 32, 64)

# kernel name -> launches since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {"packed_attention": 0, "flash_attention": 0}


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


# ---------------------------------------------------------------------------
# Packed-QKV attention (replaces _packed_fwd_kernel, flash_attention.py:796)

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


def packed_flash_attention_reference(
        qkv: torch.Tensor, heads: int, scale: Optional[float] = None,
        kv_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the packed kernel → (out (B, S, H·dh) in
    qkv's dtype, lse (B, S, H) fp32).

    Follows the TPU kernel's arithmetic: fp32 scores and softmax
    statistics, the unnormalised exp rounded to the value dtype before the
    PV product, the output divided by the row sum after it.
    """
    b, s, three_hd = qkv.shape
    hd = three_hd // 3
    dh = hd // heads
    if scale is None:
        scale = dh ** -0.5
    kv_valid = _kv_valid(kv_valid, s)
    q, k, v = (t.reshape(b, s, heads, dh).transpose(1, 2)
               for t in qkv.split(hd, dim=-1))
    sc = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    sc = _mask_keys(sc, kv_valid)
    m = sc.amax(dim=-1, keepdim=True)
    e = torch.exp(sc - m)
    denom = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e.to(v.dtype).float(), v.float()) / denom
    out = o.transpose(1, 2).reshape(b, s, hd).to(qkv.dtype)
    lse = (m + torch.log(denom)).squeeze(-1).transpose(1, 2)
    return out, lse.contiguous()


def packed_flash_attention_fwd(
        qkv: torch.Tensor, heads: int, scale: Optional[float] = None,
        kv_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``packed_flash_attention`` that also returns the fp32 lse (B, S, H)."""
    if qkv.ndim != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError(
            f"qkv must be (B, S, 3·H·dh) with H={heads}, got {tuple(qkv.shape)}")
    b, s, three_hd = qkv.shape
    hd = three_hd // 3
    dh = hd // heads
    if scale is None:
        scale = dh ** -0.5
    kv_valid = _kv_valid(kv_valid, s)
    if qkv.device.type == "cpu":
        return packed_flash_attention_reference(qkv, heads, scale, kv_valid)

    from vision_transformers_tpu_torch.ops import _build

    _check_cuda_operand("qkv", qkv, qkv.dtype, dh)
    out = torch.empty(b, s, hd, dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty(b, s, heads, dtype=torch.float32, device=qkv.device)
    lib = _build.load("packed_attention")
    with torch.cuda.device(qkv.device):  # launch on the tensor's card
        rc = lib.packed_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), b, s, heads, dh,
            kv_valid, float(scale), int(qkv.dtype == torch.bfloat16),
            torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(lib, "packed_attention", rc)
    LAUNCHES["packed_attention"] += 1
    return out, lse


def packed_flash_attention(qkv: torch.Tensor, heads: int,
                           scale: Optional[float] = None,
                           kv_valid: Optional[int] = None) -> torch.Tensor:
    """Self attention straight off the packed QKV projection.

    qkv: (B, S, 3·H·dh) laid out [q | k | v] along the last axis (torch
    packed-MHA column order). Returns (B, S, H·dh). ``kv_valid`` masks
    trailing pad keys: tokens >= kv_valid receive no attention. Dropout is
    not ported (the JAX kernel's in-kernel dropout belongs to training).
    """
    return packed_flash_attention_fwd(qkv, heads, scale, kv_valid)[0]


# ---------------------------------------------------------------------------
# Split-head attention (replaces _attn_kernel, flash_attention.py:75)


def _group_bias(bias: torch.Tensor, b: int, h: int, s_q: int, s_k: int
                ) -> torch.Tensor:
    """(bias_b, H, Sq, Sk) → (bias_b·H, Sq, Sk); group g = b·H + h reads
    row g % (bias_b·H), i.e. batch b reads bias[b % bias_b]."""
    if bias.ndim != 4 or bias.shape[1:] != (h, s_q, s_k) or b % bias.shape[0]:
        raise ValueError(
            f"bias must be (n, {h}, {s_q}, {s_k}) with n dividing B={b}, got "
            f"{tuple(bias.shape)}")
    return bias.reshape(bias.shape[0] * h, s_q, s_k)


def flash_attention_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        bias: Optional[torch.Tensor] = None, *, scale: Optional[float] = None,
        kv_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the split-head kernel → (out (B, H, Sq, D)
    in q's dtype, lse (B, H, Sq) fp32).

    Follows ``_attn_kernel``: fp32 scores·scale + bias, then ``kv_valid``,
    fp32 softmax, probabilities rounded to the value dtype before PV.
    """
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    kv_valid = _kv_valid(kv_valid, s_k)
    sc = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        bg = _group_bias(bias, b, h, s_q, s_k).float()
        sc = (sc.reshape(b // (bg.shape[0] // h), bg.shape[0], s_q, s_k)
              + bg).reshape(b, h, s_q, s_k)
    sc = _mask_keys(sc, kv_valid)
    m = sc.amax(dim=-1, keepdim=True)
    e = torch.exp(sc - m)
    denom = e.sum(dim=-1, keepdim=True)
    p = e * (1.0 / denom)
    out = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
    return out, (m + torch.log(denom)).squeeze(-1)


def flash_attention_fwd(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        bias: Optional[torch.Tensor] = None, *, scale: Optional[float] = None,
        kv_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention`` that also returns the fp32 lse (B, H, Sq)."""
    if q.ndim != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(
            "q must be (B, H, Sq, D) and k, v (B, H, Sk, D); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    kv_valid = _kv_valid(kv_valid, s_k)
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
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    bias_g = 0
    if bias is not None:
        bias = _group_bias(bias, b, h, s_q, s_k).float().contiguous()
        if bias.device != q.device:
            raise ValueError(f"bias on {bias.device}, q on {q.device}")
        bias_g = bias.shape[0]
    out = torch.empty_like(q)
    lse = torch.empty(b, h, s_q, dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):  # launch on the tensor's card
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b * h, s_q, s_k, d, bias_g,
            kv_valid, float(scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attention", rc)
    LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *,
                    scale: Optional[float] = None,
                    kv_valid: Optional[int] = None) -> torch.Tensor:
    """Batched attention over (B, H, S, D) inputs.

    ``bias`` is additive, (1 | n | B, H, Sq, Sk) with n dividing B: a leading
    dim smaller than B is broadcast over the batch (batch b reads
    bias[b % n], as Swin's per-window bias needs). ``kv_valid`` masks
    trailing key padding. Sq may differ from Sk.
    """
    return flash_attention_fwd(q, k, v, bias, scale=scale,
                               kv_valid=kv_valid)[0]
