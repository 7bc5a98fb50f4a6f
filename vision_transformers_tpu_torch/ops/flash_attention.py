"""Attention kernels for Hopper, forward and backward, each beside its plain
version.

Counterpart of ``vision_transformers_tpu/ops/flash_attention.py``. All
thirteen of its TPU kernels are ported, as CUDA C++ in ``csrc/``:

- ``packed_flash_attention`` (``csrc/packed_attention.cu``) replaces
  ``_packed_fwd_kernel`` and ``_packed_bwd_kernel``: self attention read in
  place from the packed (B, S, 3·H·dh) QKV projection, with in-kernel
  probability dropout; the backward recomputes the probabilities from
  (qkv, lse), replays the dropout mask and writes the packed dqkv. For bf16
  both run on the tensor cores, on the tiles of
  ``csrc/attention_mma_tile.cuh`` and ``csrc/attention_bwd_mma_tile.cuh``
  with the packed row strides; for fp32 on the CUDA cores.
- ``flash_dropout_attention`` (``csrc/dropout_attention.cu``) replaces
  ``_drop_fwd_kernel`` and ``_drop_bwd_kernel``: split-head (B, H, S, D)
  attention with dropout, a key-padding mask and Sq != Sk. For bf16 the
  forward runs on the tensor cores (``csrc/attention_mma_tile.cuh``) and so
  does the backward (``csrc/attention_bwd_mma_tile.cuh``).
- ``flash_attention`` (``csrc/flash_attention.cu``) replaces
  ``_attn_kernel``: split-head attention with an additive bias, on the
  tensor cores for bf16 (``csrc/attention_mma_tile.cuh``). Without a
  bias its backward is the ``flash_dropout_attention`` backward kernel at
  rate 0; with a bias it is plain PyTorch (dq, dk, dv and dbias), as the JAX
  package computes that case outside any kernel.
- ``window_packed_attention`` and ``window_batched_attention``
  (``csrc/window_attention.cu``) replace ``_window_pack_kernel`` and
  ``_window_batched_kernel``: Swin's per-window attention read in place
  from the partitioned (G, N, 3·H·dh) projection, with a shared or
  per-window bias. For bf16 both run on the tensor cores
  (``csrc/window_mma_tile.cuh``, ``window_route``); the batched one walks a
  run of windows per block with the shared bias staged once.
- ``fused_window_attention`` (``csrc/window_fused_attention.cu``) replaces
  ``_window_fused_kernel`` (the slab plan) and ``_window_fused_flat_kernel``
  (the flat plan): cyclic shift, window partition, attention, reverse and
  un-shift in one pass over the NHWC projection map. For bf16 both run on
  the tensor cores (``csrc/window_mma_tile.cuh``, through a row table of
  each window's flat rows; a slab block keeps to one window row), for fp32
  on the CUDA cores (``window_route``).
- ``window_attention_bwd`` (``csrc/window_attention_bwd.cu``) replaces
  ``_window_pack_bwd_kernel``, the backward the four window kernels share:
  from (qkv, bias, dO) it recomputes the probabilities and gives the packed
  dqkv and the bias gradient, for bf16 on the tensor cores
  (``csrc/window_mma_tile.cuh``, ``window_route``). The fused wrapper's
  backward rolls and partitions the map and dO around it in plain PyTorch,
  as the JAX package does in plain XLA.
- ``flash_attention_large_fwd`` (``csrc/flash_attention_large.cu``)
  replaces ``_large_kernel``: the streaming forward that ``flash_attention``
  takes for a runtime key-padding ``kv_mask`` and for bias-free
  Sq·Sk > 1.5 M (the DETR encoder and cross attention at COCO scale). For
  bf16 it runs on the tensor cores and skips the 64-key tiles past the last
  one that holds an attended key (``masked_tile_counts`` reads how many).
- ``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``) replaces
  ``_bwd_kernel``: the bias-free, mask-free backward of ``flash_attention``
  at small S, taken under ``USE_PALLAS_BWD`` as in the JAX package.
- ``fused_attention_block`` (``csrc/fused_block.cu``) replaces
  ``_fused_block_kernel``: LayerNorm, QKV projection, attention,
  out-projection and residual of a pre-LN encoder layer in one launch (the
  ``USE_FUSED_BLOCK`` inference path); for bf16 (``fused_block_route``)
  every product runs on the tensor cores, on ``csrc/dense_mma_tile.cuh``
  and ``csrc/attention_mma_tile.cuh``. Its backward differentiates the
  plain version, as the JAX package recomputes it in jnp.

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

"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

# The TPU kernels' finite mask value (flash_attention.py:44), also used by
# the CUDA kernels (csrc/attention_tile.cuh).
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# Score elements (Sq·Sk) above which the split-head forward switches to the
# streaming kernel, which takes no bias (the JAX package's _SMALL_S_LIMIT).
MAX_SCORE_ELEMS = 1_500_000

# The JAX package's switch (flash_attention.py:2404): its bias-free, mask-free
# backward takes the small-S kernel (_bwd_kernel) below _PALLAS_BWD_MIN_SCORES
# only when this is set; it is off there because it measured slower than the
# jnp backward on a TPU v5e. Here the alternative is the row-6 kernel at rate
# 0, which serves every size.
USE_PALLAS_BWD = False
_PALLAS_BWD_MIN_SCORES = 512 * 512 + 1

# Rows 1-7 (the packed, split-head, dropout, streaming and small-S
# attention kernels, forward and backward) take any head dim, as the JAX
# kernels do: D 16, 32, 64 and 128 are instantiations of their tiles (rows 1
# and 7: 16, 32 and 64), any other D up to 128 runs in the next one with the
# columns past D read as zeros (TNT: D 12 and 128; ViT-H/14: D 80), and a D
# above 128 (any ViT(num_heads=...) whose width allows it: ViT-B/16's
# widths at 3 heads, D 256) takes csrc/attention_wide_tile.cuh's kernels,
# D split across the grid in chunks. The fused block (row 8) takes the same
# head dims in its attention phase (fused_block_supported).
ATTENTION_HEAD_DIM_RULE = "D >= 1"
# Head dims of the window kernels (rows 9-13), those of the JAX window plans
# (dh <= 64 dividing 128): 16, 32 and 64 are instantiations of their tiles,
# 1, 2, 4 and 8 run in the 16 tile with the columns past dh read as zeros.
WINDOW_HEAD_DIMS = (1, 2, 4, 8, 16, 32, 64)


def attention_head_dim_supported(d: int) -> bool:
    """Whether rows 1-7 take head dim ``d`` on the card."""
    return d >= 1


# kernel name -> launches since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {
    "packed_attention": 0, "flash_attention": 0, "packed_attention_bwd": 0,
    "dropout_attention_fwd": 0, "dropout_attention_bwd": 0,
    "window_packed_attention": 0, "window_batched_attention": 0,
    "window_fused_slab_attention": 0, "window_fused_flat_attention": 0,
    "window_attention_bwd": 0,
    # ops/fused_adam.py (replaces fused_adam.py::_adam_kernel)
    "fused_adam": 0,
    "flash_attention_large": 0, "flash_attention_bwd": 0,
    # ops/fused_dense.py (replaces fused_dense.py::_ln_dense_kernel)
    "ln_dense": 0,
    "fused_attention_block": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def masked_tile_counts(name: str) -> Tuple[int, int]:
    """(key tiles walked, key tiles held) by the bf16 forward of
    ``"flash_attention_large"`` (row 3) or ``"dropout_attention"`` (row 5),
    summed over its launches since the last call, which zeroes both: the
    counters the kernel itself keeps, so ``1 - walked / held`` is the share
    of 64-key tiles it skipped. Synchronises with the card."""
    from vision_transformers_tpu_torch.ops import _build

    lib = _build.load(name)
    torch.cuda.synchronize()
    counts = (ctypes.c_ulonglong * 2)()
    _build.check(lib, name, getattr(lib, f"{name}_tile_counts")(counts))
    return int(counts[0]), int(counts[1])


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
                        head_dim: int,
                        head_dims: Optional[Tuple[int, ...]] = None) -> None:
    """What a CUDA kernel takes: a contiguous CUDA tensor of ``dtype``
    (float32 or bfloat16) and a head dim of ``ATTENTION_HEAD_DIM_RULE``
    (rows 1-8), or of ``head_dims`` where a row keeps its own
    (``WINDOW_HEAD_DIMS``, rows 9-13); anything else raises
    ``ValueError``."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"{name}: dtype {t.dtype}; the kernel takes float32 or bfloat16, "
            "the same for every operand")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if head_dims is None:
        if not attention_head_dim_supported(head_dim):
            raise ValueError(
                f"head dim {head_dim} not supported by the attention CUDA "
                f"kernels (rows 1-8 take {ATTENTION_HEAD_DIM_RULE})")
    elif head_dim not in head_dims:
        raise ValueError(
            f"head dim {head_dim} not supported by the CUDA kernel "
            f"(supported: {head_dims}; rows 1-8 take "
            f"{ATTENTION_HEAD_DIM_RULE})")


def _check_same_device(ref: torch.Tensor, **others: torch.Tensor) -> None:
    for name, t in others.items():
        if t.device != ref.device:
            raise ValueError(f"{name} on {t.device}, expected {ref.device}")


def _check_into(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.shape != like.shape or t.dtype != like.dtype \
            or t.device != like.device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {tuple(like.shape)} "
                         f"{like.dtype} tensor on {like.device}")


def _outputs(q: torch.Tensor, out: Optional[torch.Tensor],
             lse: Optional[torch.Tensor], lse_shape) -> Tuple[torch.Tensor,
                                                              torch.Tensor]:
    """(out like q, fp32 lse of ``lse_shape``): the given ones, checked, or
    new ones."""
    if out is None:
        out = torch.empty_like(q)
    if lse is None:
        lse = torch.empty(lse_shape, dtype=torch.float32, device=q.device)
    _check_into("out", out, q)
    if tuple(lse.shape) != tuple(lse_shape) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous {tuple(lse_shape)} "
                         f"float32 tensor on {q.device}")
    return out, lse


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
    if dh < 1:
        raise ValueError(f"head dim {dh}: rows 1-7 take "
                         f"{ATTENTION_HEAD_DIM_RULE}")
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
        kv_valid: Optional[int] = None, *, out: Optional[torch.Tensor] = None,
        lse: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed forward → (out, fp32 lse (B, S, H)); no autograd graph.
    ``out`` / ``lse`` (CUDA only): contiguous tensors of those shapes to
    write into instead of new ones. bf16 runs on the tensor cores
    (``packed_fwd_mma_kernel``; at a dh other than 16, 32 and 64 up to 128
    ``packed_fwd_mma_padded_kernel``, above 128 ``packed_fwd_mma_wide_kernel``)
    and needs qkv and out 16-byte aligned (4-byte for an even dh not a
    multiple of 8), or the launch raises; fp32 on the CUDA cores
    (``packed_fwd_kernel``, ``packed_fwd_padded_kernel``,
    ``packed_fwd_wide_kernel``). dh: ``ATTENTION_HEAD_DIM_RULE``."""
    b, s, hd, dh, scale, kv_valid = _packed_dims(qkv, heads, scale, kv_valid)
    rate, seed = _dropout_args(dropout_rate, seed)
    if qkv.device.type == "cpu":
        return packed_flash_attention_reference(qkv, heads, scale, rate, seed,
                                                kv_valid)

    from vision_transformers_tpu_torch.ops import _build

    _check_cuda_operand("qkv", qkv, qkv.dtype, dh)
    if out is None:
        out = torch.empty(b, s, hd, dtype=qkv.dtype, device=qkv.device)
    if lse is None:
        lse = torch.empty(b, s, heads, dtype=torch.float32, device=qkv.device)
    for name, t, shape, dtype in (("out", out, (b, s, hd), qkv.dtype),
                                  ("lse", lse, (b, s, heads), torch.float32)):
        if t.shape != shape or t.dtype != dtype or t.device != qkv.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} {dtype} "
                             f"tensor on {qkv.device}")
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
        kv_valid: Optional[int] = None, *,
        dqkv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The packed backward: (qkv, do, out, lse) of a forward with the same
    ``scale``, ``dropout_rate``, ``seed`` and ``kv_valid`` → dqkv. Every
    element of dqkv is written. Gradients are equal from run to run: dk and
    dv are summed in a fixed order, without atomics. ``dqkv`` (CUDA only): a
    contiguous tensor like qkv to write into instead of a new one. bf16
    takes the tensor cores (``packed_bwd_dq_mma_kernel``,
    ``packed_bwd_dkv_mma_kernel``; ``*_padded_kernel`` at a dh other than
    16, 32 and 64 up to 128, ``*_wide_kernel`` above), where qkv, do, out
    and dqkv must be aligned as the forward's operands or the launch raises;
    fp32 the CUDA cores."""
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
    if dqkv is None:
        dqkv = torch.empty_like(qkv)
    _check_into("dqkv", dqkv, qkv)
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
    if d < 1:
        raise ValueError(f"head dim {d}: rows 1-7 take "
                         f"{ATTENTION_HEAD_DIM_RULE}")
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


# The bf16 backward's tiles (csrc/attention_bwd_mma_tile.cuh): 64 query rows
# or keys per block, and about as many 128-thread blocks as fill the H100's
# 132 SMs twice.
_MMA_TILE = 64
_FILL_BLOCKS = 2 * 132


def dkv_chunks(groups: int, s_q: int, s_k: int) -> int:
    """Ranges the bf16 backward's dk/dv pass splits its query loop into. One
    block per (group, 64 keys) cannot fill the card when G·ceil(Sk/64) is
    small (PVT stage 1: G 32, Sk 49 → 32 blocks, each looping over 49 query
    tiles), so the loop is cut into up to ceil(264 / blocks) equal ranges
    whose fp32 partial dk/dv a third launch adds in order. A function of the
    shape alone, so reruns stay bit-equal; 1 = no split."""
    blocks = groups * -(-s_k // _MMA_TILE)
    nq = -(-s_q // _MMA_TILE)
    if blocks >= _FILL_BLOCKS or nq == 1:
        return 1
    per = -(-nq // min(nq, -(-_FILL_BLOCKS // blocks)))
    return -(-nq // per)


def flash_dropout_attention_fwd(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        dropout_rate: float, seed: Optional[int],
        scale: Optional[float] = None, kv_valid: Optional[int] = None,
        key_mask: Optional[torch.Tensor] = None,
        out: Optional[torch.Tensor] = None,
        lse: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dropout forward → (out, fp32 lse (B, H, Sq)); no autograd graph.
    bf16 runs on the tensor cores (skipping the 64-key tiles past the last
    one that holds an attended key), fp32 on the CUDA cores; a bf16 operand
    off its copies' grain raises (16 bytes at D 16, 32, 64, 128 and a
    multiple of 8 above 64, 4 at another even D, none at an odd D). D:
    ``ATTENTION_HEAD_DIM_RULE``. ``out``, ``lse`` (CUDA
    only): contiguous tensors to write into instead of new ones (a check
    can pre-fill them to see that every element is written)."""
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
    out, lse = _outputs(q, out, lse, (b, h, s_q))
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
        key_mask: Optional[torch.Tensor] = None,
        grads: Optional[Tuple[torch.Tensor, ...]] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dropout backward → (dq, dk, dv) in the inputs' dtype; dk and dv
    are accumulated in fp32 in a fixed order and cast once. At rate 0 it is
    also the bias-free backward of ``flash_attention``. bf16 runs on the
    tensor cores (with ``dkv_chunks`` ranges of the query loop in the dk/dv
    pass), fp32 on the CUDA cores; a bf16 operand off its copies' grain
    raises (as the forward's). D: ``ATTENTION_HEAD_DIM_RULE``. ``grads``
    (CUDA only): (dq, dk, dv), contiguous tensors like q, k, v to write into
    instead of new ones."""
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
    if grads is None:
        grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    for name, t, like in zip(("dq", "dk", "dv"), grads, (q, k, v)):
        _check_into(name, t, like)
    dq, dk, dv = grads
    delta = torch.empty(b * h * s_q, dtype=torch.float32, device=q.device)
    is_bf16 = q.dtype == torch.bfloat16
    # the wide kernels (d > 128) never split: their grid has ceil(d / 64)
    # times the dk/dv blocks already
    chunks = dkv_chunks(b * h, s_q, s_k) if is_bf16 and d <= 128 else 1
    part = None  # the chunks' fp32 partial dk and dv
    if chunks > 1:
        part = torch.empty(2 * chunks * b * h * s_k * d, dtype=torch.float32,
                           device=q.device)
    lib = _build.load("dropout_attention")
    with torch.cuda.device(q.device):
        rc = lib.dropout_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask_add is None else mask_add.data_ptr(),
            do.data_ptr(), out.data_ptr(), lse.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            None if part is None else part.data_ptr(), b * h, h, s_q, s_k, d,
            kv_valid, chunks, scale, int(is_bf16),
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
        bias: Optional[torch.Tensor] = None, *,
        kv_mask: Optional[torch.Tensor] = None,
        scale: Optional[float] = None,
        kv_valid: Optional[int] = None, out: Optional[torch.Tensor] = None,
        lse: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-head forward → (out, fp32 lse (B, H, Sq)); no autograd
    graph. ``out``, ``lse`` (CUDA, split-head route only): as
    ``flash_dropout_attention_fwd``'s. Routes as ``_flash_fwd`` does (flash_attention.py:143-147): a
    ``kv_mask``, or Sq·Sk > ``MAX_SCORE_ELEMS``, takes the streaming kernel,
    which has no bias (``ValueError`` with one). Otherwise bf16 runs on the
    tensor cores and fp32 on the CUDA cores; a bf16 operand off its
    copies' grain raises (as ``flash_dropout_attention_fwd``'s). D:
    ``ATTENTION_HEAD_DIM_RULE`` (both kernels)."""
    b, h, s_q, s_k, d, scale, kv_valid = _split_dims(q, k, v, scale, kv_valid,
                                                     kv_mask)
    if kv_mask is not None or s_q * s_k > MAX_SCORE_ELEMS:
        if bias is not None:
            raise ValueError(
                "bias is not supported with kv_mask or Sq·Sk > "
                f"{MAX_SCORE_ELEMS} (the streaming kernel takes none)")
        if lse is not None:
            raise ValueError("lse= is for the split-head route")
        return flash_attention_large_fwd(q, k, v, kv_mask=kv_mask,
                                         scale=scale, kv_valid=kv_valid,
                                         out=out)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, scale=scale,
                                         kv_valid=kv_valid)

    from vision_transformers_tpu_torch.ops import _build

    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda_operand(name, t, q.dtype, d)
    _check_same_device(q, k=k, v=v)
    bias_g = 0
    if bias is not None:
        bias = _group_bias(bias, b, h, s_q, s_k).float().contiguous()
        _check_same_device(q, bias=bias)
        bias_g = bias.shape[0]
    out, lse = _outputs(q, out, lse, (b, h, s_q))
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


# ---------------------------------------------------------------------------
# Streaming forward with a key-padding mask (replaces _large_kernel,
# flash_attention.py:229, launched by _flash_fwd_large, :276)


def flash_attention_large_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        kv_mask: Optional[torch.Tensor] = None,
        scale: Optional[float] = None,
        kv_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the streaming forward → (out (B, H, Sq, D)
    in q's dtype, lse (B, H, Sq) fp32), in ``_large_kernel``'s arithmetic
    (:244-273): fp32 scores·scale REPLACED by ``DEFAULT_MASK_VALUE`` where
    the key is >= ``kv_valid`` or masked; the max starts at
    ``DEFAULT_MASK_VALUE``; the unnormalised probabilities rounded to the
    value dtype before PV; out = acc / max(l, 1e-30), lse = m + log of the
    same. ``kv_mask``: bool (B, Sk), True = attend, the same for every head
    of an image. A row whose keys are all masked averages its Sk values
    uniformly, as ``mha_reference`` does (the TPU kernel's zero-padded block
    keys count there too; not carried over)."""
    b, h, s_q, s_k, d, scale, kv_valid = _split_dims(q, k, v, scale, kv_valid,
                                                     kv_mask)
    sc = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    keep = (torch.arange(s_k, device=q.device) < kv_valid).expand(b, s_k)
    if kv_mask is not None:
        keep = keep & kv_mask
    sc = torch.where(keep[:, None, None, :], sc,
                     torch.full_like(sc, DEFAULT_MASK_VALUE))
    m = sc.amax(dim=-1, keepdim=True).clamp_min(DEFAULT_MASK_VALUE)
    e = torch.exp(sc - m)
    denom = e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(e.to(v.dtype).float(), v.float()) / denom
    return out.to(q.dtype), (m + torch.log(denom)).squeeze(-1)




def flash_attention_large_fwd(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        kv_mask: Optional[torch.Tensor] = None,
        scale: Optional[float] = None,
        kv_valid: Optional[int] = None,
        out: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The streaming forward → (out, fp32 lse (B, H, Sq)); no autograd
    graph. Any Sq·Sk: the S×S scores never reach device memory. ``out``
    (CUDA only): a contiguous tensor like q to write into instead of a new
    one (a check can pre-fill it to see that every element is written).
    bf16 runs on the tensor cores (skipping the 64-key tiles past the last
    one that holds an attended key), fp32 on the CUDA cores; a bf16 q, k, v
    or ``out`` off its copies' grain raises (as
    ``flash_dropout_attention_fwd``'s). D: ``ATTENTION_HEAD_DIM_RULE``, any
    other D up to 128 in the next tile
    (``flash_large_mma_padded_kernel``, ``flash_large_padded_kernel``), above
    128 split across the grid (``flash_large_mma_wide_kernel``,
    ``flash_large_wide_kernel``)."""
    b, h, s_q, s_k, d, scale, kv_valid = _split_dims(q, k, v, scale, kv_valid,
                                                     kv_mask)
    if q.device.type == "cpu":
        return flash_attention_large_reference(q, k, v, kv_mask=kv_mask,
                                               scale=scale, kv_valid=kv_valid)

    from vision_transformers_tpu_torch.ops import _build

    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda_operand(name, t, q.dtype, d)
    _check_same_device(q, k=k, v=v)
    if kv_mask is not None:
        kv_mask = kv_mask.contiguous()
        _check_same_device(q, kv_mask=kv_mask)
    if out is None:
        out = torch.empty_like(q)
    _check_into("out", out, q)
    lse = torch.empty(b, h, s_q, dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention_large")
    with torch.cuda.device(q.device):  # launch on the tensor's card
        rc = lib.flash_attention_large_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b * h, b, s_q, s_k, d, kv_valid,
            scale, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attention_large", rc)
    LAUNCHES["flash_attention_large"] += 1
    return out, lse


# ---------------------------------------------------------------------------
# Small-S backward (replaces _bwd_kernel, flash_attention.py:362, launched by
# _flash_bwd_pallas, :399)

# Shared memory a block may ask for on the H100 (227 KB).
_SMEM_LIMIT = 232448


def flash_bwd_smem_bytes(s_q: int, s_k: int, d: int) -> int:
    """Shared memory of ``csrc/flash_attention_bwd.cu``'s fp32 kernel at
    D <= 128 for one group: K and V resident as fp32 (rows rounded up to 32,
    stride d + 1), lse and δ of every query row, one q and one do tile, two
    32 × 33 score tiles. Within ``_SMEM_LIMIT`` that kernel runs; past it the
    fp32 backward streams (the entry's choice, not a route rule)."""
    r32 = lambda x: -(-x // 32) * 32  # noqa: E731
    return 4 * (2 * r32(s_k) * (d + 1) + 2 * r32(s_q) + 2 * 32 * (d + 1)
                + 2 * 32 * 33)


def flash_bwd_supported(s_q: int, s_k: int, d: int) -> bool:
    """The small-S backward's route, the JAX package's
    (``_flash_attention_bwd``, :2414-2425): below ``_PALLAS_BWD_MIN_SCORES``
    scores, at any head dim ``d`` (``_flash_bwd_pallas`` sizes its group
    block from ``_BWD_SCORE_BUDGET`` and refuses no shape; every shape
    here has a kernel)."""
    del d  # no head-dim term, as in JAX
    return s_q * s_k < _PALLAS_BWD_MIN_SCORES


def flash_attention_bwd_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, do: torch.Tensor, *, scale: Optional[float] = None,
        kv_valid: Optional[int] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the small-S backward → (dq, dk, dv) in the
    inputs' dtype, from ``_bwd_kernel``'s formulas (:373-397): p =
    exp(s − lse) with keys >= kv_valid masked, δ = rowsum(do ⊙ out) in
    fp32, ds = p ⊙ (do·vᵀ − δ); dq = ds·k·scale, dv = pᵀ·do,
    dk = dsᵀ·q·scale, with ds and p rounded to the input dtype before their
    products, as the TPU kernel rounds them. lse is (B, H, Sq)."""
    b, h, s_q, s_k, d, scale, kv_valid = _split_dims(q, k, v, scale, kv_valid)
    dtype = q.dtype
    sc = _mask_keys(torch.matmul(q.float(), k.float().transpose(-1, -2))
                    * scale, kv_valid)
    p = torch.exp(sc - lse.unsqueeze(-1))
    dof = do.float()
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    ds = (p * (torch.matmul(dof, v.float().transpose(-1, -2)) - delta)).to(
        dtype).float()
    dq = torch.matmul(ds, k.float()) * scale
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), dof)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def flash_attention_bwd(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, do: torch.Tensor, *, scale: Optional[float] = None,
        kv_valid: Optional[int] = None,
        grads: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The small-S backward of a bias-free, mask-free forward with the same
    ``scale`` and ``kv_valid``: (q, k, v, out, lse, do) → (dq, dk, dv).
    bf16 runs on the tensor cores (two launches; a bf16 operand that is not
    16-byte aligned raises), rounding ds unscaled and pᵀ before their
    products as ``_bwd_kernel`` does; fp32 on the CUDA cores, one launch of
    one block per group where the group's K and V fit its shared memory
    (``flash_bwd_smem_bytes``), else the two streaming passes of
    ``flash_bwd_{dq,dkv}_wide_kernel``. Every output has one owner, so two
    runs give equal bits. Any shape (the route, ``flash_bwd_supported``, is
    the JAX package's score budget). D: ``ATTENTION_HEAD_DIM_RULE``, any
    other D up to 128 in the next tile (``*_padded_kernel``), above 128 the
    two passes of ``*_wide_kernel`` in either dtype. ``grads`` (CUDA only):
    contiguous (dq, dk, dv) like (q, k, v) to write into."""
    b, h, s_q, s_k, d, scale, kv_valid = _split_dims(q, k, v, scale, kv_valid)
    if do.shape != q.shape or out.shape != q.shape \
            or lse.shape != (b, h, s_q):
        raise ValueError(
            f"do and out must be {tuple(q.shape)} and lse {(b, h, s_q)}; got "
            f"{tuple(do.shape)}, {tuple(out.shape)}, {tuple(lse.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, do,
                                             scale=scale, kv_valid=kv_valid)

    from vision_transformers_tpu_torch.ops import _build

    do = do.contiguous()  # arrives as a view of the caller's transpose
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do), ("out", out)):
        _check_cuda_operand(name, t, q.dtype, d)
    _check_cuda_operand("lse", lse, torch.float32, d)
    _check_same_device(q, k=k, v=v, do=do, out=out, lse=lse)
    if grads is None:
        grads = (torch.empty_like(q), torch.empty_like(k),
                 torch.empty_like(v))
    dq, dk, dv = grads
    for name, t, like in (("dq", dq, q), ("dk", dk, k), ("dv", dv, v)):
        _check_into(name, t, like)
    is_bf16 = q.dtype == torch.bfloat16
    # δ, written by the two-pass routes' first pass and read by their second
    # (bf16; fp32 at D > 128 or past the resident kernel's shared memory)
    two_pass = (is_bf16 or d > 128
                or flash_bwd_smem_bytes(s_q, s_k, d) > _SMEM_LIMIT)
    delta = (torch.empty(b * h * s_q, dtype=torch.float32, device=q.device)
             if two_pass else None)
    lib = _build.load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if delta is None else delta.data_ptr(),
            b * h, s_q, s_k, d, kv_valid, scale, int(is_bf16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attention_bwd", rc)
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """``_flash_attention``'s custom_vjp (flash_attention.py:2389-2469)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, kv_mask, scale, kv_valid):
        out, lse = flash_attention_fwd(q, k, v, bias, kv_mask=kv_mask,
                                       scale=scale, kv_valid=kv_valid)
        ctx.save_for_backward(q, k, v, bias, kv_mask, out, lse)
        _, _, _, _, _, ctx.scale, ctx.kv_valid = _split_dims(q, k, v, scale,
                                                             kv_valid)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, kv_mask, out, lse = ctx.saved_tensors
        kw = dict(scale=ctx.scale, kv_valid=ctx.kv_valid)
        dbias = None
        if bias is not None:
            dq, dk, dv, dbias = flash_attention_bias_bwd(
                q, k, v, bias, do, out, lse, **kw)
        elif (kv_mask is None and USE_PALLAS_BWD
              and flash_bwd_supported(q.shape[2], k.shape[2], q.shape[3])):
            dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, **kw)
        else:
            # the JAX package takes this kernel from Sq·Sk >= 512² + 1 and
            # jnp below (and for a kv_mask); here it serves every size: the
            # same function, and no S×S tensor in device memory (four
            # (G, 4704, 4704) fp32 tensors at the DETR encoder's shape)
            dq, dk, dv = flash_dropout_attention_bwd(
                q, k, v, do, out, lse, dropout_rate=0.0, seed=None,
                key_mask=kv_mask, **kw)
        return dq, dk, dv, dbias, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *,
                    kv_mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    kv_valid: Optional[int] = None) -> torch.Tensor:
    """Batched attention over (B, H, S, D) inputs.

    ``bias`` is additive, (1 | n | B, H, Sq, Sk) with n dividing B: a leading
    dim smaller than B is broadcast over the batch (batch b reads
    bias[b % n], as Swin's per-window bias needs). ``kv_mask``: bool
    (B, Sk) keep-mask (per-image key padding, True = attend), broadcast over
    heads; it takes the streaming kernel, as does a bias-free
    Sq·Sk > ``MAX_SCORE_ELEMS``; neither takes a bias. ``kv_valid`` masks
    trailing key padding. Sq may differ from Sk. Differentiable in q, k, v
    and bias.
    """
    return _Flash.apply(q, k, v, bias, kv_mask, scale, kv_valid)


# ---------------------------------------------------------------------------
# Window attention (replaces _window_pack_kernel, flash_attention.py:1295,
# _window_batched_kernel, :1708, _window_fused_flat_kernel, :1997,
# _window_fused_kernel, :2056, and their shared backward
# _window_pack_bwd_kernel, :1466)
#
# One function, four forward kernels and one backward: per (window g, head h)
#   out = softmax(q·kᵀ·scale + bias[g mod nW', h])·v
# with q, k, v read in place from the packed projection, N <= 128 tokens per
# window and the bias rounded to the compute dtype. The packed and batched
# kernels take the partitioned (G, N, 3·H·dh) tensor; the two fused kernels
# take the NHWC map and fold roll, partition, reverse and un-roll into their
# addressing.
#
# Two facts of the TPU layout are not carried over, on purpose. The TPU
# kernels pack P = 128/dh windows block-diagonally into one MXU product and
# tile the bias to the packs (`_pack_window_bias`, with an lcm-periodic
# pattern when nW' does not divide into packs); here the contract is
# "window g reads bias row g mod nW'" (windows vary fastest in G), one modulo
# in the kernel. And the TPU's fused kernels want the q, k, v sections padded
# to 128 lanes (sec = roundup(H·dh, 128)); here the section stride is an
# argument and callers pass the unpadded map.

# Tokens per window and head dims the window kernels' contract covers (the
# conditions of the JAX plans that are about the function, not about VMEM).
MAX_WINDOW_TOKENS = 128
# Launch shape limits of the CUDA-core window kernels: one thread per query
# row, K and V of the block's windows as fp32 in shared memory.
_WINDOW_MAX_THREADS = 256
_WINDOW_MAX_SMEM = 96 * 1024
_H100_SMS = 132
# The backward kernel also keeps two fp32 N×N tiles per window in shared
# memory: as many windows per block as leave room for two blocks on an SM,
# and at least one (N = 128, dh = 64 takes 193 KB of the 227 KB a block may
# ask for).
_WINDOW_BWD_SMEM_TARGET = 100 * 1024
_WINDOW_BWD_SMEM_LIMIT = 232448


def _window_shape_ok(n: int, dh: int) -> bool:
    return 0 < dh <= 64 and 128 % dh == 0 and 0 < n <= MAX_WINDOW_TOKENS


def _window_block(n: int, dh: int, count: Optional[int] = None
                  ) -> Tuple[int, int]:
    """(windows per pass, threads per block) of a window kernel: one thread
    per query row, so the pass's P·N rows should fill whole warps. Without
    ``count`` the cheapest P per window wins; with it (the slab kernel's
    windows per row) the fewest thread slots over ceil(count / P) passes."""
    best = None
    for p in range(1, max(1, _WINDOW_MAX_THREADS // n) + 1):
        if p > 1 and p * n * dh * 8 > _WINDOW_MAX_SMEM:
            break
        if count is not None and p > count:
            break
        threads = -(-p * n // 32) * 32
        cost = (threads / p if count is None
                else -(-count // p) * threads)
        if best is None or cost <= best[0]:
            best = (cost, p, threads)
    return best[1], best[2]


def window_pack_plan(g: int, n: int, heads: int, dh: int, bias_windows: int,
                     itemsize: int = 2):
    """(windows per block, threads) for ``window_packed_attention``, or None
    if the shape is outside the function's contract (dh <= 64 dividing 128,
    N <= 128). ``bias_windows`` (1 or n_win) need not divide anything. The
    JAX plan's ``g % p`` and VMEM conditions are the TPU's and are dropped:
    the kernel bounds-checks a ragged last block. The launch shape of the
    CUDA-core kernel (fp32, ``window_route``); the tensor-core kernel (bf16)
    takes its own from N, and the C entry only checks this one."""
    if not _window_shape_ok(n, dh) or g < 1:
        return None
    return _window_block(n, dh)


def window_batched_plan(g: int, n: int, heads: int, dh: int,
                        bias_windows: int, itemsize: int = 2):
    """(windows per pass, threads, passes per block) for
    ``window_batched_attention``, or None for N > 128. A block stages its
    head's shared bias once and walks ``passes`` groups of windows; fewer
    passes when G·H is too small to fill the card otherwise. The JAX plan's
    ``g % blk`` condition is the TPU's and is dropped."""
    if not 0 < n <= MAX_WINDOW_TOKENS or g < 1:
        return None
    p, threads = _window_block(n, dh)
    passes = max(1, min(8, (g * heads) // (p * _H100_SMS * 4)))
    return p, threads, passes


def _window_bwd_smem(p: int, n: int, dh: int) -> int:
    """Bytes of shared memory of the backward kernel for p windows: K/V (then
    Q/dO) as (N, dh) fp32 and two (N, N|1) fp32 score tiles each."""
    return p * n * (2 * dh + 2 * (n | 1)) * 4


def window_bwd_plan(g: int, n: int, heads: int, dh: int):
    """(windows per block, threads) for ``window_attention_bwd``, or None if
    the shape is outside the window kernels' contract. One thread per row,
    so the block's P·N rows should fill whole warps, within the shared
    memory that leaves two blocks to an SM. The JAX plan
    (``_window_pack_bwd_gblk``) is a VMEM budget and a ``g % p`` condition,
    facts of the TPU: here every shape the forward kernels take has a
    backward kernel. The launch shape of the CUDA-core kernel (fp32,
    ``window_route``); the tensor-core kernel (bf16) takes its own from N,
    and the C entry only checks this one."""
    if not _window_shape_ok(n, dh) or g < 1 \
            or _window_bwd_smem(1, n, dh) > _WINDOW_BWD_SMEM_LIMIT:
        return None
    best = (-(-n // 32) * 32, 1)
    for p in range(2, _WINDOW_MAX_THREADS // n + 1):
        if _window_bwd_smem(p, n, dh) > _WINDOW_BWD_SMEM_TARGET:
            break
        threads = -(-p * n // 32) * 32
        if threads / p <= best[0] / best[1]:
            best = (threads, p)
    return best[1], best[0]


WINDOW_KERNELS = ("packed", "bwd", "batched", "fused_flat", "fused_slab")


def window_route(dtype: torch.dtype, n: int, dh: int,
                 kernel: str = "packed") -> str:
    """The route of a CUDA launch of a window kernel, from the operands
    alone, before any launch. ``kernel`` names it: ``"packed"``
    (``window_packed_attention``, row 9), ``"bwd"``
    (``window_attention_bwd``, row 10), ``"batched"``
    (``window_batched_attention``, row 11), ``"fused_flat"`` and
    ``"fused_slab"`` (``fused_window_attention``'s flat and slab plans, rows
    12 and 13). ``"tensor_cores"`` (every product on ``mma.sync``:
    ``window_packed_mma_kernel``, ``window_bwd_mma_kernel``,
    ``window_batched_mma_kernel``, ``window_fused_flat_mma_kernel``,
    ``window_fused_slab_mma_kernel``; dh 1, 2, 4 and 8 in their 16 tile)
    for bf16, ``"cuda_cores"`` for fp32, at every
    shape the window kernels take: 1 <= N <= 128 tokens and a head dim of
    ``WINDOW_HEAD_DIMS`` (the JAX plans' dh <= 64 dividing 128). Any other
    shape, dtype or kernel raises ``ValueError``. A shape rule, not a
    fallback: the C entries take the same kernel by the dtype, and a launch
    on it that fails raises."""
    if kernel not in WINDOW_KERNELS:
        raise ValueError(f"window kernels are {WINDOW_KERNELS}, got {kernel!r}")
    if not 0 < n <= MAX_WINDOW_TOKENS or dh not in WINDOW_HEAD_DIMS:
        raise ValueError(
            f"window kernels take 1 <= N <= {MAX_WINDOW_TOKENS} and a head "
            f"dim of {WINDOW_HEAD_DIMS}, got N = {n}, dh = {dh}")
    if dtype == torch.bfloat16:
        return "tensor_cores"
    if dtype == torch.float32:
        return "cuda_cores"
    raise ValueError(f"window kernels take float32 or bfloat16, got {dtype}")


def _fused_geometry_ok(hp, wp, wh, ww, dh, bias_windows) -> bool:
    if not _window_shape_ok(wh * ww, dh):
        return False
    if hp % wh or wp % ww or hp < wh or wp < ww:
        return False
    return bias_windows in (1, (hp // wh) * (wp // ww))


def window_fused_plan(b: int, hp: int, wp: int, wh: int, ww: int, heads: int,
                      dh: int, bias_windows: int, itemsize: int = 2):
    """("slab", windows per pass, threads) for the slab kernel of
    ``fused_window_attention`` (a block per image, window row and head; in
    bf16 per run of a window row, the C code's choice), or None. The
    windows per pass and threads are the CUDA-core kernel's launch shape
    (fp32, ``window_route``); the tensor-core kernel (bf16) takes its own
    from N, and the C entry only checks this one.

    ``wp % 8 == 0`` is kept from the JAX plan although it is a fact of the
    TPU's DMA (a sliced copy needs 8-aligned rows): it is the rule that
    gives the slab and the flat kernel the shapes they have in the
    reference (Swin-T @224: stage 1 here, stages 2-3 flat)."""
    if not _fused_geometry_ok(hp, wp, wh, ww, dh, bias_windows) or wp % 8:
        return None
    return ("slab",) + _window_block(wh * ww, dh, count=wp // ww)


def window_fused_flat_plan(b: int, hp: int, wp: int, wh: int, ww: int,
                           heads: int, dh: int, bias_windows: int,
                           itemsize: int = 2):
    """("flat", windows per block, threads) for the flat kernel of
    ``fused_window_attention`` (blocks of consecutive windows over the flat
    (B·Hp·Wp, 3·sec) view, any width), or None."""
    if not _fused_geometry_ok(hp, wp, wh, ww, dh, bias_windows):
        return None
    return ("flat",) + _window_block(wh * ww, dh)


def _window_dims(qkv: torch.Tensor, heads: int, scale: Optional[float]):
    if qkv.ndim != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError(
            f"qkv must be (G, N, 3·H·dh) with H={heads}, got {tuple(qkv.shape)}")
    g, n, three_hd = qkv.shape
    hd = three_hd // 3
    dh = hd // heads
    return g, n, hd, dh, dh ** -0.5 if scale is None else float(scale)


def _window_bias(bias: Optional[torch.Tensor], g: int, heads: int, n: int,
                 dtype: torch.dtype) -> Optional[torch.Tensor]:
    """(nW', H, N, N) rounded to the compute dtype, as every window kernel
    holds it; nW' must divide G (window g reads row g mod nW'). Its storage
    starts on a 16-byte boundary: the bf16 tensor-core kernels of rows 11
    and 12 copy a window's row by 16-byte chunks of the tensor."""
    if bias is None:
        return None
    if bias.ndim != 4 or bias.shape[1:] != (heads, n, n) \
            or g % bias.shape[0]:
        raise ValueError(
            f"bias must be (nW', {heads}, {n}, {n}) with nW' dividing G={g}, "
            f"got {tuple(bias.shape)}")
    bias = bias.to(dtype).contiguous()
    return bias.clone() if bias.data_ptr() % 16 else bias


def window_attention_reference(qkv: torch.Tensor,
                               bias: Optional[torch.Tensor], heads: int,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the packed and batched window kernels
    (``_window_pack_ref``, flash_attention.py:1405): fp32 scores, the bias
    rounded to qkv's dtype, probabilities normalised and then rounded to the
    value dtype before PV. (G, N, 3·H·dh) → (G, N, H·dh)."""
    g, n, hd, dh, scale = _window_dims(qkv, heads, scale)
    bias = _window_bias(bias, g, heads, n, qkv.dtype)
    q, k, v = (t.reshape(g, n, heads, dh).transpose(1, 2)
               for t in qkv.split(hd, dim=-1))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        nw = bias.shape[0]
        s = (s.reshape(g // nw, nw, heads, n, n) + bias.float()).reshape(
            g, heads, n, n)
    pr = torch.softmax(s, dim=-1)
    o = torch.matmul(pr.to(v.dtype).float(), v.float())
    return o.transpose(1, 2).reshape(g, n, hd).to(qkv.dtype)


def window_attention_bwd_reference(
        qkv: torch.Tensor, bias: Optional[torch.Tensor], do: torch.Tensor,
        heads: int, scale: Optional[float] = None, need_dbias: bool = True
        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the window backward → (dqkv (G, N, 3·H·dh)
    in qkv's dtype, dbias in the bias's shape and dtype or None), written
    out from the TPU kernel's formulas (flash_attention.py:1500-1559,
    :1607-1617), not autograd of the forward:

    s = q·kᵀ·scale + bias (rounded to qkv's dtype), p = softmax(s) in fp32,
    dp = do·vᵀ, ds = p ⊙ (dp − rowsum(dp ⊙ p)); dv = pᵀ·do with p rounded to
    the value dtype; dq = (ds·scale)·k and dk = (ds·scale)ᵀ·q with ds·scale
    rounded to the q dtype; dbias[w] = the fp32 sum, over the windows g with
    g mod nW' = w, of ds rounded to qkv's dtype first (the TPU kernel emits
    ds in that dtype and sums it outside)."""
    g, n, hd, dh, scale = _window_dims(qkv, heads, scale)
    if do.shape != (g, n, hd):
        raise ValueError(f"do must be {(g, n, hd)}, got {tuple(do.shape)}")
    dtype = qkv.dtype
    bias_c = _window_bias(bias, g, heads, n, dtype)
    q, k, v = (t.reshape(g, n, heads, dh).transpose(1, 2).float()
               for t in qkv.split(hd, dim=-1))
    dof = do.reshape(g, n, heads, dh).transpose(1, 2).float()
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias_c is not None:
        nw = bias_c.shape[0]
        s = (s.reshape(g // nw, nw, heads, n, n) + bias_c.float()).reshape(
            g, heads, n, n)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dp = torch.matmul(dof, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), dof)
    ds_c = (ds * scale).to(dtype).float()
    dq = torch.matmul(ds_c, k)
    dk = torch.matmul(ds_c.transpose(-1, -2), q)
    dqkv = torch.cat([t.transpose(1, 2).reshape(g, n, hd)
                      for t in (dq, dk, dv)], dim=-1).to(dtype)
    dbias = None
    if bias is not None and need_dbias:
        dbias = _reduce_window_ds(ds.to(dtype), bias)
    return dqkv, dbias


def _reduce_window_ds(ds: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The kernel's per-window score gradient (G, H, N, N), in the compute
    dtype, summed in fp32 over the windows that read one bias row → dbias
    in the bias's shape and dtype (flash_attention.py:1609-1617; plain jnp
    there, plain PyTorch here)."""
    g, heads, n, _ = ds.shape
    nw = bias.shape[0]
    return ds.float().reshape(g // nw, nw, heads, n, n).sum(dim=0).to(
        bias.dtype)


def _fused_dims(qkv_map, heads, window, shift, dh, scale):
    if qkv_map.ndim != 4 or qkv_map.shape[-1] % 3:
        raise ValueError("qkv_map must be (B, Hp, Wp, 3·sec), got "
                         f"{tuple(qkv_map.shape)}")
    b, hp, wp, three_sec = qkv_map.shape
    sec = three_sec // 3
    wh, ww = (int(w) for w in window)
    sh, sw = (int(s) for s in shift)
    if dh is None:
        dh = sec // heads
    hd = heads * dh
    if hd > sec or hd < 1:
        raise ValueError(f"H·dh = {hd} does not fit the section stride {sec}")
    if hp % wh or wp % ww or not (0 <= sh < hp and 0 <= sw < wp):
        raise ValueError(
            f"map {hp}x{wp} must be a multiple of the window {wh}x{ww} and "
            f"the shift ({sh}, {sw}) inside it")
    scale = dh ** -0.5 if scale is None else float(scale)
    return b, hp, wp, sec, wh, ww, sh, sw, dh, hd, scale


def window_fused_reference(qkv_map: torch.Tensor,
                           bias: Optional[torch.Tensor], heads: int,
                           window: Sequence[int], shift: Sequence[int],
                           scale: Optional[float] = None,
                           hd: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the fused kernels (``_window_fused_ref``,
    flash_attention.py:2263): the explicit roll(−shift) → partition →
    ``window_attention_reference`` → reverse → roll(+shift) chain on the
    (B, Hp, Wp, 3·sec) map. ``hd``: the real H·dh when the sections are
    padded (sec = map channels / 3); the output is (B, Hp, Wp, sec) with
    zeros in the pad lanes."""
    dh = None if hd is None else hd // heads
    b, hp, wp, sec, wh, ww, sh, sw, dh, hd, scale = _fused_dims(
        qkv_map, heads, window, shift, dh, scale)
    x = qkv_map
    if hd != sec:
        x = torch.cat([x[..., s * sec:s * sec + hd] for s in range(3)], dim=-1)
    if sh or sw:
        x = torch.roll(x, shifts=(-sh, -sw), dims=(1, 2))
    x = x.reshape(b, hp // wh, wh, wp // ww, ww, 3 * hd).permute(
        0, 1, 3, 2, 4, 5).reshape(-1, wh * ww, 3 * hd)
    o = window_attention_reference(x, bias, heads, scale)
    o = o.reshape(b, hp // wh, wp // ww, wh, ww, hd).permute(
        0, 1, 3, 2, 4, 5).reshape(b, hp, wp, hd)
    if sh or sw:
        o = torch.roll(o, shifts=(sh, sw), dims=(1, 2))
    if hd != sec:
        o = torch.nn.functional.pad(o, (0, sec - hd))
    return o


def window_grain(dh: int, itemsize: int) -> int:
    """The bytes a window kernel copies a row by, at head dim ``dh``: 16,
    or a whole row where it is narrower (dh 1-4 in bf16, 1-2 in fp32: the
    offsets of such rows keep only their own width's alignment)."""
    return min(16, dh * itemsize)


def _check_window_operands(name: str, qkv: torch.Tensor,
                           bias: Optional[torch.Tensor], dh: int,
                           sec: int) -> None:
    """What the CUDA window kernels take: see ``_check_cuda_operand``; rows
    are read by copies of ``window_grain`` bytes, so qkv and its section
    stride must keep that alignment."""
    _check_cuda_operand("qkv", qkv, qkv.dtype, dh, WINDOW_HEAD_DIMS)
    grain = window_grain(dh, qkv.element_size())
    if qkv.data_ptr() % grain or (sec * qkv.element_size()) % grain:
        raise ValueError(
            f"{name}: qkv must be {grain}-byte aligned with sections of a "
            f"multiple of {grain} bytes")
    if bias is not None:
        _check_same_device(qkv, bias=bias)


def _window_launch(lib_name: str, fn: str, counter: str, qkv: torch.Tensor,
                   bias: Optional[torch.Tensor], out: torch.Tensor,
                   *args) -> torch.Tensor:
    from vision_transformers_tpu_torch.ops import _build

    lib = _build.load(lib_name)
    with torch.cuda.device(qkv.device):  # launch on the tensor's card
        rc = getattr(lib, fn)(
            qkv.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), *args, int(qkv.dtype == torch.bfloat16),
            torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(lib, lib_name, rc)
    LAUNCHES[counter] += 1
    return out


def _window_forward(kind: str, qkv: torch.Tensor,
                    bias: Optional[torch.Tensor], heads: int,
                    scale: Optional[float], plan) -> torch.Tensor:
    """The packed (``kind`` "packed") or batched forward; no autograd graph."""
    g, n, hd, dh, scale = _window_dims(qkv, heads, scale)
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, bias, heads, scale)
    name = f"window_{kind}_attention"
    _check_window_operands(name, qkv, bias, dh, hd)
    window_route(qkv.dtype, n, dh, kind)
    bias = _window_bias(bias, g, heads, n, qkv.dtype)
    out = torch.empty(g, n, hd, dtype=qkv.dtype, device=qkv.device)
    return _window_launch(
        "window_attention", f"{name}_fwd", name, qkv, bias, out, g, n, heads,
        dh, 0 if bias is None else bias.shape[0], scale, *plan)


def window_attention_bwd(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                         do: torch.Tensor, heads: int,
                         scale: Optional[float] = None,
                         need_dbias: bool = True, *,
                         dqkv: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The backward the four window kernels share: (qkv, bias) of a forward
    with the same ``scale`` and the output's gradient do (G, N, H·dh) →
    (dqkv (G, N, 3·H·dh), dbias in the bias's shape and dtype, or None
    without a bias or with ``need_dbias`` false).

    Nothing of the forward is kept: the kernel recomputes the probabilities
    with the forward's max-before-exp, from the bias rounded to qkv's dtype
    as the forward read it. Every element of dqkv is written, and two runs
    give equal bits (no atomics). For dbias the kernel writes the score
    gradient (G, H, N, N) in qkv's dtype and the sum over the windows that
    share a bias row is taken here, in fp32; with ``need_dbias`` false
    nothing of it is written. ``dqkv`` (CUDA only): a contiguous tensor
    like qkv to write into instead of a new one. On the card bf16 takes the
    tensor cores, fp32 the CUDA cores (``window_route``)."""
    g, n, hd, dh, scale = _window_dims(qkv, heads, scale)
    if do.shape != (g, n, hd):
        raise ValueError(f"do must be {(g, n, hd)}, got {tuple(do.shape)}")
    if qkv.device.type == "cpu":
        return window_attention_bwd_reference(qkv, bias, do, heads, scale,
                                              need_dbias)
    plan = window_bwd_plan(g, n, heads, dh)
    if plan is None:
        raise ValueError(
            f"window_attention_bwd: N = {n}, dh = {dh} not supported")

    from vision_transformers_tpu_torch.ops import _build

    do = do.contiguous()  # arrives as a view of the caller's reverse
    _check_window_operands("window_attention_bwd", qkv, bias, dh, hd)
    _check_cuda_operand("do", do, qkv.dtype, dh, WINDOW_HEAD_DIMS)
    _check_same_device(qkv, do=do)
    grain = window_grain(dh, qkv.element_size())
    if do.data_ptr() % grain:
        raise ValueError(
            f"window_attention_bwd: do must be {grain}-byte aligned")
    route = window_route(qkv.dtype, n, dh, "bwd")
    if dqkv is None:
        dqkv = torch.empty_like(qkv)
    elif dqkv.shape != qkv.shape or dqkv.dtype != qkv.dtype \
            or dqkv.device != qkv.device or not dqkv.is_contiguous():
        raise ValueError("dqkv must be a contiguous tensor like qkv")
    bias_c = _window_bias(bias, g, heads, n, qkv.dtype)
    ds = None
    if bias is not None and need_dbias:
        ds = torch.empty(g, heads, n, n, dtype=qkv.dtype, device=qkv.device)
    p, threads = plan
    lib = _build.load("window_attention_bwd")
    with torch.cuda.device(qkv.device):  # launch on the tensor's card
        rc = lib.window_attention_bwd(
            qkv.data_ptr(), None if bias_c is None else bias_c.data_ptr(),
            do.data_ptr(), dqkv.data_ptr(),
            None if ds is None else ds.data_ptr(), g, n, heads, dh,
            0 if bias_c is None else bias_c.shape[0], scale, p, threads,
            int(route == "tensor_cores"),
            torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(lib, "window_attention_bwd", rc)
    LAUNCHES["window_attention_bwd"] += 1
    return dqkv, None if ds is None else _reduce_window_ds(ds, bias)


class _WindowAttention(torch.autograd.Function):
    """``_window_pack``'s and ``_window_batched``'s custom_vjp
    (flash_attention.py:1620-1658, :1769-1803): saves (qkv, bias) only; both
    share one backward."""

    @staticmethod
    def forward(ctx, qkv, bias, heads, scale, kind, plan):
        out = _window_forward(kind, qkv, bias, heads, scale, plan)
        ctx.save_for_backward(qkv, bias)
        ctx.args = (heads, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, bias = ctx.saved_tensors
        dqkv, dbias = window_attention_bwd(
            qkv, bias, do, *ctx.args, need_dbias=ctx.needs_input_grad[1])
        return dqkv, dbias, None, None, None, None


def window_packed_attention(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                            heads: int, scale: Optional[float] = None,
                            plan=None) -> torch.Tensor:
    """Multi-window attention on the partitioned projection output.

    qkv: (G, N, 3·H·dh) with G = batch·n_win (windows fastest); bias:
    (1 | nW', H, N, N) combined relative-position (+ shift or pad mask) bias
    or None; window g reads bias row g mod nW'. ``plan`` from
    ``window_pack_plan`` (computed if omitted). Returns (G, N, H·dh).
    Differentiable in qkv and bias (``window_attention_bwd``).

    On the card (``window_route``): in bf16 a block of the tensor-core
    kernel takes a few windows of one head, a warp per 16 query rows, with
    each window's q, k, v and bias row in shared memory; in fp32 the
    CUDA-core kernel gives a block as many windows of one head as fill its
    threads with query rows (one thread per row), each window reading its
    own bias row from device memory."""
    g, n, hd, dh, scale = _window_dims(qkv, heads, scale)
    if plan is None:
        plan = window_pack_plan(g, n, heads, dh,
                                1 if bias is None else bias.shape[0],
                                qkv.element_size())
    if plan is None:
        raise ValueError("shape not supported; check window_pack_plan first")
    return _WindowAttention.apply(qkv, bias, heads, scale, "packed", plan)


def window_batched_attention(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                             heads: int, scale: Optional[float] = None,
                             blk=None) -> torch.Tensor:
    """Per-head batched window attention: the same function, shapes and
    backward as ``window_packed_attention``, for the case the router sends
    it (a bias shared by all windows). ``blk`` from ``window_batched_plan``
    (computed if omitted).

    A block of the CUDA kernel belongs to one head and stages that head's
    shared (N, N) bias in shared memory once, then reuses it over several
    windows (``window_route``). In bf16 the tensor-core kernel walks a run
    of windows (its length from G·H and the card:
    ``csrc/window_mma_tile.cuh``'s ``window_run_launch``), a warp per 16
    query rows of a window,
    the next window's q, k and v copied while the current one computes, the
    bias held as bf16; in fp32 the CUDA-core kernel walks ``passes`` groups
    of windows, one thread per query row. A per-window bias (nW' > 1) is
    staged per window (bf16) or read from device memory (fp32) instead."""
    g, n, hd, dh, scale = _window_dims(qkv, heads, scale)
    if blk is None:
        blk = window_batched_plan(g, n, heads, dh,
                                  1 if bias is None else bias.shape[0],
                                  qkv.element_size())
    if blk is None:
        raise ValueError("shape not supported; check window_batched_plan")
    return _WindowAttention.apply(qkv, bias, heads, scale, "batched", blk)


def _fused_window_forward(qkv_map, bias, heads, window, shift, dh, scale,
                          plan, out):
    """The slab or flat forward; no autograd graph."""
    b, hp, wp, sec, wh, ww, sh, sw, dh, hd, scale = _fused_dims(
        qkv_map, heads, window, shift, dh, scale)
    if qkv_map.device.type == "cpu":
        return window_fused_reference(qkv_map, bias, heads, (wh, ww),
                                      (sh, sw), scale, hd)
    name = f"fused_window_attention ({plan[0]})"
    _check_window_operands(name, qkv_map, bias, dh, sec)
    window_route(qkv_map.dtype, wh * ww, dh, f"fused_{plan[0]}")
    nwin = (hp // wh) * (wp // ww)
    bias = _window_bias(bias, nwin, heads, wh * ww, qkv_map.dtype)
    if out is None:
        alloc = torch.empty if sec == hd else torch.zeros  # zero pad lanes
        out = alloc(b, hp, wp, sec, dtype=qkv_map.dtype,
                    device=qkv_map.device)
    elif out.shape != (b, hp, wp, sec) or out.dtype != qkv_map.dtype \
            or out.device != qkv_map.device or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {(b, hp, wp, sec)} "
                         f"{qkv_map.dtype} tensor on {qkv_map.device}")
    kind, p, threads = plan
    return _window_launch(
        "window_fused_attention", f"window_fused_{kind}_attention_fwd",
        f"window_fused_{kind}_attention", qkv_map, bias, out, b, hp, wp, wh,
        ww, sh, sw, heads, dh, sec, 0 if bias is None else bias.shape[0],
        scale, p, threads)


def _fused_window_backward(qkv_map, bias, do, heads, window, shift, dh, scale,
                           need_dbias):
    """``_window_fused_bwd_rule`` (flash_attention.py:2310-2336): the
    roll(−shift) → partition chain on the map and on do, cropped to the real
    H·dh, in plain PyTorch (plain XLA there) around ``window_attention_bwd``;
    dqkv reversed and rolled back to the map, zeros in the pad lanes."""
    b, hp, wp, sec, wh, ww, sh, sw, dh, hd, scale = _fused_dims(
        qkv_map, heads, window, shift, dh, scale)
    x, do = qkv_map, do[..., :hd]
    if hd != sec:
        x = torch.cat([x[..., s * sec:s * sec + hd] for s in range(3)], dim=-1)
    if sh or sw:
        x = torch.roll(x, shifts=(-sh, -sw), dims=(1, 2))
        do = torch.roll(do, shifts=(-sh, -sw), dims=(1, 2))

    def partition(t):
        return t.reshape(b, hp // wh, wh, wp // ww, ww, t.shape[-1]).permute(
            0, 1, 3, 2, 4, 5).reshape(-1, wh * ww, t.shape[-1])

    dqkv, dbias = window_attention_bwd(partition(x), bias, partition(do),
                                       heads, scale, need_dbias)
    dmap = dqkv.reshape(b, hp // wh, wp // ww, wh, ww, 3 * hd).permute(
        0, 1, 3, 2, 4, 5).reshape(b, hp, wp, 3 * hd)
    if sh or sw:
        dmap = torch.roll(dmap, shifts=(sh, sw), dims=(1, 2))
    if hd != sec:
        padded = dmap.new_zeros(b, hp, wp, 3 * sec)
        for s in range(3):
            padded[..., s * sec:s * sec + hd] = dmap[..., s * hd:(s + 1) * hd]
        dmap = padded
    return dmap, dbias


class _FusedWindowAttention(torch.autograd.Function):
    """``_window_fused``'s custom_vjp (flash_attention.py:2298-2351)."""

    @staticmethod
    def forward(ctx, qkv_map, bias, heads, window, shift, dh, scale, plan):
        out = _fused_window_forward(qkv_map, bias, heads, window, shift, dh,
                                    scale, plan, None)
        ctx.save_for_backward(qkv_map, bias)
        ctx.args = (heads, window, shift, dh, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        qkv_map, bias = ctx.saved_tensors
        dmap, dbias = _fused_window_backward(
            qkv_map, bias, do, *ctx.args, need_dbias=ctx.needs_input_grad[1])
        return dmap, dbias, None, None, None, None, None, None


def fused_window_attention(qkv_map: torch.Tensor,
                           bias: Optional[torch.Tensor], heads: int,
                           window: Sequence[int], shift: Sequence[int],
                           dh: Optional[int] = None,
                           scale: Optional[float] = None,
                           plan=None, *,
                           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shifted-window attention straight off the dense NHWC projection map.

    qkv_map: (B, Hp, Wp, 3·sec), [q | k | v] sections of stride sec >= H·dh
    (the port passes the unpadded map, sec = H·dh; ``dh`` says otherwise),
    padded to window multiples but NOT rolled. bias: (1 | nr·nw, H, N, N) or
    None. Returns (B, Hp, Wp, sec) in the un-rolled coordinates.

    Equals roll(−shift) → window_partition → window attention →
    window_reverse → roll(+shift) (``window_fused_reference``), but no
    rolled, partitioned or reversed tensor is made: window (R, c) reads rows
    (R·wh + r + sh) mod Hp and columns (c·ww + j + sw) mod Wp of the map
    and writes its outputs to the same positions. ``plan`` from
    ``window_fused_plan`` (the slab kernel: one block per image, window row
    and head; computed if omitted) or ``window_fused_flat_plan`` (the flat
    kernel: blocks of consecutive windows of the flat view, any width).
    Differentiable in qkv_map and bias: the backward makes the rolled and
    partitioned tensors the forward avoids, around ``window_attention_bwd``.
    ``out`` (CUDA only, no gradient): a contiguous (B, Hp, Wp, sec) tensor
    to write into instead of a new one; a check can pre-fill it to see that
    every element of [..., :H·dh] is written."""
    b, hp, wp, sec, wh, ww, sh, sw, dh, hd, scale = _fused_dims(
        qkv_map, heads, window, shift, dh, scale)
    if plan is None:
        plan = window_fused_plan(b, hp, wp, wh, ww, heads, dh,
                                 1 if bias is None else bias.shape[0],
                                 qkv_map.element_size())
    if plan is None:
        raise ValueError("shape not supported; check window_fused_plan")
    if out is None:
        return _FusedWindowAttention.apply(qkv_map, bias, heads, (wh, ww),
                                           (sh, sw), dh, scale, plan)
    if torch.is_grad_enabled() and (
            qkv_map.requires_grad
            or (bias is not None and bias.requires_grad)):
        raise ValueError("fused_window_attention: out= takes no gradient")
    return _fused_window_forward(qkv_map, bias, heads, (wh, ww), (sh, sw), dh,
                                 scale, plan, out)


# ---------------------------------------------------------------------------
# Fused attention sub-block (replaces _fused_block_kernel,
# flash_attention.py:1028, launched by _fused_block_fwd_pallas :1074)


def fused_block_supported(hd: int, heads: int) -> bool:
    """The port's size rule for ``fused_attention_block``, in place of the
    JAX package's VMEM budget (``fused_block_supported(s, hd, itemsize)``,
    :1015, which counts Wqkv and Wout resident in a TPU core's VMEM and has
    no head-dim term). The CUDA kernels keep no operand resident: weights,
    qkv and keys stream through fixed shared-memory tiles, the rest goes
    through a device-memory workspace. So neither S nor the width is
    limited, and every head dim has a tile (``ATTENTION_HEAD_DIM_RULE``): the
    one condition is heads that divide the width. A superset of the JAX
    rule: ViT-L (hd 1024) and ViT-H/14 (hd 1280, dh 80) are admitted, which
    the VMEM budget excludes."""
    return heads > 0 and hd > 0 and hd % heads == 0


def fused_block_route(dtype: torch.dtype, hd: int, heads: int,
                      strides: Tuple[int, int, int, int]) -> str:
    """The route of a CUDA launch of the fused sub-block, from the operands
    alone, before any launch: ``"tensor_cores"`` (``fused_block_mma_kernel``
    at dh 16, 32 and 64, ``fused_block_mma_padded_kernel`` at any other dh
    up to 128, ``fused_block_mma_wide_kernel`` above; every product on
    ``mma.sync``) for bf16 whose width H·dh is a multiple of 8 (odd and
    narrow dh included) and whose two weights lie in one layout — both (in,
    out) (ldn = 1) or both torch's (out, in) (ldk = 1) — at leading strides
    that are multiples of 8 (the 16-byte rows the dense tiles' copies need;
    every model of the repo); else ``"cuda_cores"`` (``fused_block_kernel``,
    ``fused_block_padded_kernel``, ``fused_block_wide_kernel``).
    ``strides``: (ldk, ldn) of Wqkv, then of Wout. A shape rule, not a
    fallback: a launch on the chosen route that fails raises."""
    ldk1, ldn1, ldk3, ldn3 = strides
    if ldk1 == 1 and ldk3 == 1:
        leads = (ldn1, ldn3)
    elif ldn1 == 1 and ldn3 == 1:
        leads = (ldk1, ldk3)
    else:
        return "cuda_cores"
    if dtype == torch.bfloat16 and fused_block_supported(hd, heads) \
            and hd % 8 == 0 and all(ld % 8 == 0 for ld in leads):
        return "tensor_cores"
    return "cuda_cores"


def _block_dims(x, wqkv, wout, heads, scale):
    if x.ndim != 3:
        raise ValueError(f"x must be (B, S, H·dh), got {tuple(x.shape)}")
    hd = x.shape[-1]
    if hd % heads or wqkv.shape != (hd, 3 * hd) or wout.shape != (hd, hd):
        raise ValueError(
            f"x (B, S, {hd}) with {heads} heads needs wqkv ({hd}, {3 * hd}) "
            f"and wout ({hd}, {hd}); got {tuple(wqkv.shape)}, "
            f"{tuple(wout.shape)}")
    dh = hd // heads
    return hd, dh, dh ** -0.5 if scale is None else float(scale)


def _row(t: torch.Tensor) -> torch.Tensor:
    """An fp32 (1, n) row (or (n,)) → (n,) fp32."""
    return t.reshape(-1).float()


def fused_attention_block_reference(
        x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
        wqkv: torch.Tensor, bqkv: torch.Tensor, wout: torch.Tensor,
        bout: torch.Tensor, heads: int, scale: Optional[float] = None,
        eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the fused sub-block, differentiable in all
    seven tensors: x + out_proj(attention(qkv_proj(LN(x)))) with the TPU
    kernel's arithmetic (flash_attention.py:1028-1071): fp32 LN statistics,
    xn·γ + β rounded to x's dtype, qkv in fp32 + bqkv rounded, attention as
    ``packed_flash_attention_reference`` computes it (the unnormalised exp
    rounded to the value dtype before P·V, as the kernel rounds it — the
    JAX twin ``_fused_block_ref`` rounds the normalised probabilities
    instead; in fp32 the two coincide), then attn·Wout in fp32 + bout + the
    fp32 x, one rounding. Weights (in, out) in x's dtype, any strides."""
    hd, _, scale = _block_dims(x, wqkv, wout, heads, scale)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    xn = ((xf - mu) * torch.rsqrt(var + eps) * _row(gamma)
          + _row(beta)).to(x.dtype)
    qkv = (torch.matmul(xn.float(), wqkv.float()) + _row(bqkv)).to(x.dtype)
    attn, _ = packed_flash_attention_reference(qkv, heads, scale)
    out = torch.matmul(attn.float(), wout.float()) + _row(bout)
    return (out + xf).to(x.dtype)


def _weight_strides(name: str, w: torch.Tensor) -> Tuple[int, int]:
    """(ldk, ldn) of a (K, N) weight that is row-major or a transposed view
    of a row-major (N, K) tensor (torch's Linear weight ``.t()``)."""
    ldk, ldn = w.stride()
    k, n = w.shape
    if (ldn == 1 and ldk == n) or (ldk == 1 and ldn == k):
        return ldk, ldn
    raise ValueError(f"{name} must be a row-major (K, N) tensor or the "
                     f"transpose of a row-major (N, K) one; strides {w.stride()}")


def fused_attention_block_fwd(
        x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
        wqkv: torch.Tensor, bqkv: torch.Tensor, wout: torch.Tensor,
        bout: torch.Tensor, heads: int, scale: Optional[float] = None,
        eps: float = 1e-6, *, out: Optional[torch.Tensor] = None
        ) -> torch.Tensor:
    """The fused sub-block's forward, no autograd graph: one kernel launch
    on a CUDA x (the route of ``fused_block_route``), the plain version on a
    CPU one. ``out`` (CUDA only): a contiguous tensor like x to write into
    instead of a new one. On the tensor-core route x, both weights and out
    must be 16-byte aligned, or the launch raises."""
    hd, dh, scale = _block_dims(x, wqkv, wout, heads, scale)
    if x.device.type == "cpu":
        return fused_attention_block_reference(x, gamma, beta, wqkv, bqkv,
                                               wout, bout, heads, scale, eps)
    return _fused_block_launch(x, gamma, beta, wqkv, bqkv, wout, bout, heads,
                               hd, dh, scale, eps, out, None)


def _measure_fused_block_phases(
        x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
        wqkv: torch.Tensor, bqkv: torch.Tensor, wout: torch.Tensor,
        bout: torch.Tensor, heads: int, phases: Sequence[int],
        scale: Optional[float] = None, eps: float = 1e-6) -> torch.Tensor:
    """For measurement only, never on a model's path: the tensor-core
    route's ``phases`` (0 the row statistics, 1 LayerNorm + QKV, 2 the
    attention, 3 the out-projection), each as one ordinary launch of its
    own, in order, instead of the block's one cooperative launch. With all
    four the output is the block's, bit for bit; with fewer it is not. It
    raises for a CPU x and for operands the route rule sends to the CUDA
    cores."""
    hd, dh, scale = _block_dims(x, wqkv, wout, heads, scale)
    if x.device.type == "cpu" or not set(phases) <= {0, 1, 2, 3} \
            or not phases:
        raise ValueError(f"phases {tuple(phases)} of 0..3 run on the card's "
                         f"tensor-core kernel only, got x on {x.device}")
    return _fused_block_launch(x, gamma, beta, wqkv, bqkv, wout, bout, heads,
                               hd, dh, scale, eps, None,
                               sum(1 << p for p in set(phases)))


def _fused_block_launch(x, gamma, beta, wqkv, bqkv, wout, bout, heads, hd,
                        dh, scale, eps, out, phases):
    """The CUDA launch of ``fused_attention_block_fwd`` (``phases`` None) or
    of ``_measure_fused_block_phases`` (``phases`` a bit mask)."""
    from vision_transformers_tpu_torch.ops import _build

    _check_cuda_operand("x", x, x.dtype, dh)
    for name, w in (("wqkv", wqkv), ("wout", wout)):
        if not w.is_cuda or w.dtype != x.dtype:
            raise ValueError(f"{name} must be a {x.dtype} CUDA tensor, got "
                             f"{w.dtype} on {w.device}")
    _check_same_device(x, wqkv=wqkv, wout=wout)
    ldk1, ldn1 = _weight_strides("wqkv", wqkv)
    ldk3, ldn3 = _weight_strides("wout", wout)
    route = fused_block_route(x.dtype, hd, heads, (ldk1, ldn1, ldk3, ldn3))
    if phases is not None and route != "tensor_cores":
        raise ValueError("phases run on the tensor-core kernel only; these "
                         "operands take the CUDA cores")
    r = {}  # the fp32 parameter rows as contiguous (n,) tensors
    for name, t, n in (("gamma", gamma, hd), ("beta", beta, hd),
                       ("bqkv", bqkv, 3 * hd), ("bout", bout, hd)):
        if t.dtype != torch.float32 or t.device != x.device \
                or t.numel() != n:
            raise ValueError(f"{name} must hold {n} fp32 values on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
        r[name] = t.reshape(-1).contiguous()
    b, s, _ = x.shape
    if out is None:
        out = torch.empty_like(x)
    _check_into("out", out, x)
    qkv_ws = torch.empty(b, s, 3 * hd, dtype=x.dtype, device=x.device)
    attn_ws = torch.empty(b, s, hd, dtype=x.dtype, device=x.device)
    # the attention's lse, unread: the tensor-core route's at every dh, the
    # CUDA-core route's above 128 (its wide tile writes it)
    lse_ws = (torch.empty(b, s, heads, dtype=torch.float32, device=x.device)
              if route == "tensor_cores" or dh > 128 else None)
    lib = _build.load("fused_block")
    head = (x.data_ptr(), r["gamma"].data_ptr(), r["beta"].data_ptr(),
            wqkv.data_ptr(), ldk1, ldn1, r["bqkv"].data_ptr(),
            wout.data_ptr(), ldk3, ldn3, r["bout"].data_ptr(),
            qkv_ws.data_ptr(), attn_ws.data_ptr(), out.data_ptr())
    with torch.cuda.device(x.device):  # launch on the tensor's card
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "tensor_cores":
            # each row's (mean, rstd)
            stats = torch.empty(b * s, 2, dtype=torch.float32,
                                device=x.device)
            tail = (stats.data_ptr(), lse_ws.data_ptr(), b, s, heads, dh,
                    scale, float(eps))
            rc = lib.fused_block_mma_fwd(*head, *tail, stream) \
                if phases is None \
                else lib.fused_block_mma_phases(*head, *tail, phases, stream)
        else:
            rc = lib.fused_block_fwd(
                *head, None if lse_ws is None else lse_ws.data_ptr(), b, s,
                heads, dh, scale, float(eps), int(x.dtype == torch.bfloat16),
                stream)
    _build.check(lib, "fused_block", rc)
    LAUNCHES["fused_attention_block"] += 1
    return out


class _FusedBlock(torch.autograd.Function):
    """``fused_attention_block``'s custom_vjp (:1156-1159): the forward is
    the kernel; the backward differentiates the plain version, recomputed
    (the JAX package's jnp recompute; no backward kernel exists there)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, wqkv, bqkv, wout, bout, heads, scale,
                eps):
        ctx.save_for_backward(x, gamma, beta, wqkv, bqkv, wout, bout)
        ctx.args = (heads, scale, eps)
        return fused_attention_block_fwd(x, gamma, beta, wqkv, bqkv, wout,
                                         bout, heads, scale, eps)

    @staticmethod
    def backward(ctx, do):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = fused_attention_block_reference(*inputs, *ctx.args)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, do))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None, None, None)


def fused_attention_block(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, wqkv: torch.Tensor,
                          bqkv: torch.Tensor, wout: torch.Tensor,
                          bout: torch.Tensor, heads: int,
                          scale: Optional[float] = None,
                          eps: float = 1e-6) -> torch.Tensor:
    """x + out_proj(attention(qkv_proj(LN(x)))) as one kernel launch, the
    JAX package's signature and layout: x (B, S, H·dh) in the compute dtype;
    gamma, beta, bqkv, bout fp32 rows ((1, n) or (n,)); wqkv (H·dh, 3·H·dh)
    and wout (H·dh, H·dh), (in, out), in x's dtype — row-major, or the
    transpose of torch's (out, in) Linear weight, read in place. Inference
    path (``fused_block_supported``); differentiable through a recompute of
    the plain version."""
    return _FusedBlock.apply(x, gamma, beta, wqkv, bqkv, wout, bout, heads,
                             scale, eps)
