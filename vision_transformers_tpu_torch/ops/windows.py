"""Windowed (Swin-style) attention ops.

Counterpart of ``vision_transformers_tpu/ops/windows.py``: NHWC feature
maps throughout; the relative-position index, the 9-region shift mask, the
edge-pad key mask and SwinV2's coordinate table depend only on static
shapes and are computed in numpy (own copies of the JAX package's
functions); the qkv and output projections are dense matrix products on the
whole map (``torch.matmul``, as the JAX package leaves them to XLA), and
only the attention core touches the windowed layout.

**Routing.** ``shifted_window_attention`` chooses its attention function as
the JAX package does on a TPU (``windows.py:209-239, 346-403``), whatever
the device: the fused kernels only without ``logit_scale``; the batched
kernel only for a bias shared by all windows, dropout 0 and a window count
outside [2, 8]; the packed kernel otherwise; attention dropout > 0 leaves
the window kernels with one warning and takes ``dot_product_attention``.
The router never asks where the tensor lies: each wrapper in
``ops/flash_attention.py`` launches its CUDA kernel for a CUDA tensor and
runs its plain version for a CPU tensor. ``ROUTE_LOG``, when a list,
receives the name of every route taken. The split-head path (a window of
more than 128 tokens, or one no window kernel takes) runs inside the span
``vtt.window.split`` (``utils.metrics.span``): the head split, the
attention call and the reverse into the map.

The JAX plans also carry conditions that are facts of TPU tiles (``g % p``,
``g % blk``, ``(bb·nw) % p``, ``(bb·Hp·Wp) % 8``, VMEM budgets), which make
its route depend on the batch: at batch 1 Swin-T's stage 4 falls through to
the split-head kernel and its stage 3 to the packed kernel. The port's
kernels take any G (a ragged last block is bounds-checked), so its route
depends on the model and not on the batch; it equals the JAX package's
wherever every JAX plan exists (batch 32 at the 224-pixel presets, which
``tests/test_torch_port_windows.py`` checks). ``wp % 8 == 0`` is kept as the
rule that sends a map to the slab kernel and the rest to the flat one. The
VMEM budgets of the packed and fused plans are kept too, as routing rules
without the batch (``flash_attention.jax_budget_admits``, the one home of
every window plan's budget: each evaluated at the least block its plan may
choose): at dh 8 and many heads they are what refuses a path
(Swin-T's widths at 4× its heads: stage 2's shifted blocks take the packed
kernel, stage 3 the split-head path, as on the TPU). So is the batched
plan's (``window_batched_plan``, at its least block of 8 windows): from
H·dh 2176 at N 49, dh 32 in bf16 a block leaves the batched kernel for the
packed or the split-head path. The batched kernel and the backward take
any head dim, as the JAX batched plan does, so a Swin at dh 48 takes them
where the JAX package does (its other blocks the split-head path: no pack
or fused plan takes dh 48).

Two TPU layout facts are not carried over, on purpose: the q, k, v sections
are not padded to 128 lanes (the fused kernels take the section stride as an
argument and get the unpadded (B, Hp, Wp, 3·C) map), and there is no
P = 128/dh block-diagonal packing or tiled bias (window g reads bias row
g mod nW').
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vision_transformers_tpu_torch.core.dtypes import PARAM_DTYPE
from vision_transformers_tpu_torch.core.initializers import trunc_normal_, zeros_
from vision_transformers_tpu_torch.ops.attention import dot_product_attention
from vision_transformers_tpu_torch.ops.flash_attention import (
    fused_window_attention,
    jax_budget_admits,
    window_batched_attention,
    window_batched_plan,
    window_fused_flat_plan,
    window_fused_plan,
    window_pack_plan,
    window_packed_attention,
)
from vision_transformers_tpu_torch.ops.layers import Dense, Dropout, LayerNorm
from vision_transformers_tpu_torch.parallel.mesh import shard_tensor
from vision_transformers_tpu_torch.utils.metrics import span

# Test hooks, as in the JAX package: None = auto, True/False forces the
# choice of the packed kernel over the split-head path, ...
FORCE_PACK_PATH: Optional[bool] = None
# ... of the fused kernels over the partition-based paths, ...
FORCE_FUSED_WINDOW: Optional[bool] = None
# ... and of the batched kernel on the partition-based path.
FORCE_BATCHED_WINDOW: Optional[bool] = None

# When a list: every call appends the route it took, one of "fused_slab",
# "fused_flat", "batched", "pack", "split".
ROUTE_LOG: Optional[List[str]] = None

_pack_dropout_warned = False


def _record(route: str) -> None:
    if ROUTE_LOG is not None:
        ROUTE_LOG.append(route)


def _batched_preferred(n_win: int, nwp: int, drop: float) -> bool:
    if FORCE_BATCHED_WINDOW is not None:
        return FORCE_BATCHED_WINDOW
    return drop == 0.0 and nwp == 1 and not (2 <= n_win <= 8)


def _warn_pack_dropout_fallback() -> None:
    global _pack_dropout_warned
    if not _pack_dropout_warned:
        _pack_dropout_warned = True
        warnings.warn(
            "attention_dropout > 0 disengages the multi-window pack kernel "
            "for windowed attention (falls back to the split-head path); "
            "set attention_dropout=0.0 to keep the kernel path",
            RuntimeWarning,
            stacklevel=3,
        )


def window_partition(x: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, wh·ww, C). H, W must be window multiples."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // wh, wh, w // ww, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * (h // wh) * (w // ww), wh * ww, c)


def window_reverse(x: torch.Tensor, wh: int, ww: int, h: int,
                   w: int) -> torch.Tensor:
    """Inverse of window_partition."""
    bnw, _, c = x.shape
    b = bnw // ((h // wh) * (w // ww))
    x = x.reshape(b, h // wh, w // ww, wh, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """Static (N·N,) gather index into the (2wh-1)(2ww-1) bias table."""
    coords = np.stack(
        np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")
    ).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # (2, N, N)
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1).reshape(-1)


def shift_attn_mask(pad_h: int, pad_w: int, window: Sequence[int],
                    shift: Sequence[int]) -> Optional[np.ndarray]:
    """Static (nW, N, N) additive mask (0 / -100) separating the 9 regions a
    cyclic shift stitches together. None when no shift."""
    if sum(shift) == 0:
        return None
    wh, ww = window
    region = np.zeros((pad_h, pad_w), np.float32)
    h_slices = ((0, pad_h - wh), (pad_h - wh, pad_h - shift[0]),
                (pad_h - shift[0], pad_h))
    w_slices = ((0, pad_w - ww), (pad_w - ww, pad_w - shift[1]),
                (pad_w - shift[1], pad_w))
    count = 0
    for h0, h1 in h_slices:
        for w0, w1 in w_slices:
            region[h0:h1, w0:w1] = count
            count += 1
    region = region.reshape(pad_h // wh, wh, pad_w // ww, ww)
    region = region.transpose(0, 2, 1, 3).reshape(-1, wh * ww)  # (nW, N)
    diff = region[:, None, :] - region[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def edge_pad_key_mask(pad_h: int, pad_w: int, h: int, w: int,
                      window: Sequence[int]) -> Optional[np.ndarray]:
    """Static (nW, 1, N) additive key mask (0 / -1e9) marking positions that
    exist only because the map was padded to window multiples (Twins LSA
    masks them; Swin does not)."""
    if pad_h == h and pad_w == w:
        return None
    wh, ww = window
    valid = np.zeros((pad_h, pad_w), np.float32)
    valid[:h, :w] = 1.0
    valid = valid.reshape(pad_h // wh, wh, pad_w // ww, ww)
    valid = valid.transpose(0, 2, 1, 3).reshape(-1, wh * ww)  # (nW, N)
    return np.where(valid[:, None, :] > 0, 0.0, -1e9).astype(np.float32)


def relative_coords_table(wh: int, ww: int) -> np.ndarray:
    """Static (1, 2wh-1, 2ww-1, 2) log-spaced normalised coordinate table of
    SwinV2's continuous position bias: coords/(win-1) scaled to ±8, then
    sign(x)·log2(|x|+1)/3."""
    ch = np.arange(-(wh - 1), wh, dtype=np.float32)
    cw = np.arange(-(ww - 1), ww, dtype=np.float32)
    table = np.stack(np.meshgrid(ch, cw, indexing="ij"))  # (2, 2wh-1, 2ww-1)
    table = table.transpose(1, 2, 0)[None]
    if wh > 1:
        table[:, :, :, 0] /= wh - 1
    if ww > 1:
        table[:, :, :, 1] /= ww - 1
    table *= 8
    return np.sign(table) * np.log2(np.abs(table) + 1.0) / 3.0


@functools.lru_cache(maxsize=256)
def _static_mask(pad_h: int, pad_w: int, h: int, w: int, wh: int, ww: int,
                 sh: int, sw: int, mask_padding: bool,
                 device: torch.device) -> Optional[torch.Tensor]:
    """Shift mask + (with ``mask_padding``) edge-pad key mask as one fp32
    (nW, 1, N, N) tensor on ``device``, or None. A function of static shapes
    only, so it is built once per geometry and device and kept: callers add
    it to the bias and never write to it."""
    masks = [shift_attn_mask(pad_h, pad_w, (wh, ww), (sh, sw))]
    if mask_padding:
        masks.append(edge_pad_key_mask(pad_h, pad_w, h, w, (wh, ww)))
    masks = [m for m in masks if m is not None]
    if not masks:
        return None
    total = sum(masks[1:], masks[0])  # (nW, N, N) + (nW, 1, N) broadcasts
    return torch.from_numpy(np.ascontiguousarray(total)).to(device)[:, None]


def _trunc02(t: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return trunc_normal_(t, 0.02, generator)


def _l2_normalize(t: torch.Tensor) -> torch.Tensor:
    """x·rsqrt(Σx² + 1e-12) in fp32, NOT x / max(‖x‖, ε): the latter has a
    NaN gradient at x = 0, and window padding makes exact-zero rows."""
    t32 = t.float()
    sumsq = (t32 * t32).sum(dim=-1, keepdim=True)
    return (t32 * torch.rsqrt(sumsq + 1e-12)).to(t.dtype)


def _project(x: torch.Tensor, kernel: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    out = torch.matmul(x, kernel)
    return out if bias is None else out + bias


def shifted_window_attention(
    x: torch.Tensor,
    qkv_kernel: torch.Tensor,
    qkv_bias: Optional[torch.Tensor],
    proj_kernel: torch.Tensor,
    proj_bias: Optional[torch.Tensor],
    relative_position_bias: Optional[torch.Tensor],  # (num_heads, N, N)
    window_size: Sequence[int],
    num_heads: int,
    shift_size: Sequence[int],
    *,
    attention_dropout: float = 0.0,
    dropout: float = 0.0,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    mask_padding: bool = False,
    logit_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Functional core on (B, H, W, C) feature maps; kernels are flax's
    (in, out). The map is zero-padded to window multiples before the
    projection and cropped after the attention; the shift is zeroed on an
    axis whose window covers the padded map.

    ``logit_scale`` (num_heads, 1, 1) switches to SwinV2 cosine attention:
    q and k are L2-normalised along the head dim and the temperature
    exp(min(logit_scale, log 100)) is folded into q, so the attention
    function runs with scale 1. ``generator`` (a host generator) feeds the
    split-head path's dropout when ``deterministic`` is false. Projection
    dropout is the caller's."""
    b, h, w, c = x.shape
    wh, ww = window_size
    pad_b = (wh - h % wh) % wh
    pad_r = (ww - w % ww) % ww
    if pad_b or pad_r:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    pad_h, pad_w = h + pad_b, w + pad_r

    shift = list(shift_size)
    if wh >= pad_h:
        shift[0] = 0
    if ww >= pad_w:
        shift[1] = 0

    n_win = (pad_h // wh) * (pad_w // ww)
    n = wh * ww
    g = b * n_win
    # the attention's width: c, or a TP rank's share of it
    cq = qkv_kernel.shape[-1] // 3
    dh = cq // num_heads
    itemsize = x.element_size()

    # Decide the path before projecting: the fused kernels read the
    # un-rolled map, the others a rolled and partitioned one.
    drop = 0.0 if deterministic else attention_dropout
    has_mask = sum(shift) > 0 or (mask_padding and (pad_h != h or pad_w != w))
    nwp = n_win if has_mask else 1
    use_fused = (
        FORCE_FUSED_WINDOW if FORCE_FUSED_WINDOW is not None
        # cosine attention never fuses (the JAX package measured it slower
        # on its hardware; the rule is kept so both packages route alike)
        else (logit_scale is None
              and not _batched_preferred(n_win, nwp, drop))
    )
    fused_plan = None
    geo = (pad_h, pad_w, wh, ww)
    if use_fused and drop == 0.0:
        fused_plan = window_fused_plan(
            b, pad_h, pad_w, wh, ww, num_heads, dh, nwp, itemsize)
        if fused_plan is not None and not jax_budget_admits(
                "slab", n, num_heads, dh, itemsize, *geo):
            fused_plan = None
        if fused_plan is None:
            # wp % 8 != 0 (Swin-T stages 2-4): the flat kernel
            fused_plan = window_fused_flat_plan(
                b, pad_h, pad_w, wh, ww, num_heads, dh, nwp, itemsize)
            if fused_plan is not None and not jax_budget_admits(
                    "flat", n, num_heads, dh, itemsize, *geo):
                fused_plan = None

    if fused_plan is None and sum(shift) > 0:
        # roll the C-channel map BEFORE the 3C projection (a third of the
        # bytes); the roll is a permutation of positions, so it commutes
        # with the per-position projection
        x = torch.roll(x, shifts=(-shift[0], -shift[1]), dims=(1, 2))

    qkv = _project(x, qkv_kernel, qkv_bias)

    scale = 1.0 / dh ** 0.5
    if logit_scale is not None:
        temp = torch.exp(torch.clamp(logit_scale, max=math.log(100.0)))
        q5 = qkv.reshape(b, pad_h, pad_w, 3, num_heads, dh)
        qn = _l2_normalize(q5[..., 0, :, :]) * temp.reshape(
            num_heads, 1).to(qkv.dtype)
        kn = _l2_normalize(q5[..., 1, :, :])
        qkv = torch.stack([qn, kn, q5[..., 2, :, :]], dim=3).reshape(
            b, pad_h, pad_w, 3 * cq)
        scale = 1.0

    # Combined additive bias (nW', nH, N, N), nW' in {1, n_win}: the
    # relative-position bias (shared by all windows) + the per-window shift
    # mask (shared by batch and heads) + the per-window pad mask.
    mask = _static_mask(pad_h, pad_w, h, w, wh, ww, shift[0], shift[1],
                        bool(mask_padding), x.device)
    bias = None
    if relative_position_bias is not None:
        bias = relative_position_bias[None]  # (1, nH, N, N)
    if mask is not None:
        bias = mask if bias is None else bias + mask
    if bias is not None and bias.shape != (bias.shape[0], num_heads, n, n):
        bias = bias.expand(bias.shape[0], num_heads, n, n)

    if fused_plan is not None:
        _record(f"fused_{fused_plan[0]}")
        out = fused_window_attention(
            qkv, bias, num_heads, (wh, ww), tuple(shift), dh=dh, scale=scale,
            plan=fused_plan)
        # (B, Hp, Wp, C) in un-rolled coordinates
        return _project(out[:, :h, :w, :cq], proj_kernel, proj_bias)

    qkv_packed = window_partition(qkv, wh, ww)  # (B·nW, N, 3C), [q | k | v]

    # Batched kernel first, in auto mode only (FORCE_PACK_PATH pins the
    # packed kernel or the split-head path for tests).
    batched_blk = None
    if (FORCE_PACK_PATH is None and drop == 0.0
            and _batched_preferred(n_win, nwp, drop)):
        batched_blk = window_batched_plan(g, n, num_heads, dh, nwp, itemsize)
    pack_plan = None
    if batched_blk is None and (
            FORCE_PACK_PATH if FORCE_PACK_PATH is not None else True):
        pack_plan = window_pack_plan(g, n, num_heads, dh, nwp, itemsize)
        if pack_plan is not None and not jax_budget_admits(
                "pack", n, num_heads, dh, itemsize):
            pack_plan = None
        if pack_plan is not None and drop > 0.0:
            # the packed kernel has no in-kernel dropout; say so once
            _warn_pack_dropout_fallback()
            pack_plan = None

    if batched_blk is not None:
        _record("batched")
        out = window_reverse(window_batched_attention(
            qkv_packed, bias, num_heads, scale=scale, blk=batched_blk),
            wh, ww, pad_h, pad_w)
    elif pack_plan is not None:
        _record("pack")
        out = window_reverse(window_packed_attention(
            qkv_packed, bias, num_heads, scale=scale, plan=pack_plan),
            wh, ww, pad_h, pad_w)
    else:
        _record("split")
        with span("vtt.window.split"):
            q, k, v = qkv_packed.reshape(g, n, 3, num_heads, dh).permute(
                2, 0, 3, 1, 4).contiguous()  # each (B·nW, nH, N, dh)
            out = dot_product_attention(
                q, k, v, bias=bias, scale=scale, dropout_rate=drop,
                generator=generator)
            out = window_reverse(out.transpose(1, 2).reshape(g, n, cq),
                                 wh, ww, pad_h, pad_w)

    if sum(shift) > 0:
        out = torch.roll(out, shifts=(shift[0], shift[1]), dims=(1, 2))
    return _project(out[:, :h, :w, :], proj_kernel, proj_bias)


class _WindowAttentionBase(nn.Module):
    """Parameters shared by the two window attention modules, raw and named
    as in the JAX params tree (kernels are flax's (in, out)).

    Under tensor parallelism (``parallel.shard_params``) ``tp`` is set:
    ``qkv_kernel`` holds this rank's heads' columns of q, k and v and
    ``proj_kernel`` their rows; the position bias (and SwinV2's temperature
    and q/v biases) stay whole and each rank reads its heads' part of
    them."""

    tp = None

    def __init__(self, dim: int, window_size: Sequence[int],
                 shift_size: Sequence[int], num_heads: int,
                 proj_bias: bool, attention_dropout: float, dropout: float,
                 dtype: torch.dtype, generator: Optional[torch.Generator]):
        super().__init__()
        self.dim = dim
        self.window_size = tuple(window_size)
        self.shift_size = tuple(shift_size)
        self.num_heads = num_heads
        self.attention_dropout = attention_dropout
        self.dtype = dtype
        self.qkv_kernel = nn.Parameter(_trunc02(
            torch.empty(dim, 3 * dim, dtype=PARAM_DTYPE), generator))
        self.proj_kernel = nn.Parameter(_trunc02(
            torch.empty(dim, dim, dtype=PARAM_DTYPE), generator))
        self.proj_bias = (nn.Parameter(torch.zeros(dim, dtype=PARAM_DTYPE))
                          if proj_bias else None)
        self.drop = Dropout(dropout)
        wh, ww = self.window_size
        self.register_buffer(
            "_rel_index", torch.from_numpy(relative_position_index(wh, ww)),
            persistent=False)

    def _gather_bias(self, table: torch.Tensor) -> torch.Tensor:
        """((2wh-1)(2ww-1), nH) table → (nH, N, N)."""
        n = self.window_size[0] * self.window_size[1]
        return table[self._rel_index].reshape(n, n, self.num_heads).permute(
            2, 0, 1)

    def tp_divides(self, size: int) -> bool:
        return self.num_heads % size == 0

    def tp_shard(self, tp) -> None:
        self.qkv_kernel = shard_tensor(self.qkv_kernel, tp, 1, parts=3)
        if getattr(self, "qkv_bias", None) is not None:
            self.qkv_bias = shard_tensor(self.qkv_bias, tp, 0, parts=3)
        self.proj_kernel = shard_tensor(self.proj_kernel, tp, 0)
        self.tp = tp

    def _tp_heads(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's heads (dim 0) of a whole per-head tensor."""
        idx = self.tp.blocks(self.num_heads).to(t.device)
        return self.tp.copy(t).index_select(0, idx)

    def _attend(self, x, qkv_bias, rel_bias, seed, logit_scale=None):
        dt = self.dtype
        drop = self.attention_dropout if self.training else 0.0
        heads, attn_seed, tp = self.num_heads, seed, self.tp
        if tp is not None:
            x = tp.copy(x)
            rel_bias = self._tp_heads(rel_bias)
            if logit_scale is not None:
                logit_scale = self._tp_heads(logit_scale)
            heads //= tp.size
            attn_seed = tp.seed(seed)
        gen = None
        if drop > 0.0:
            if seed is None:
                raise ValueError(
                    "attention dropout in training mode needs a seed")
            gen = torch.Generator().manual_seed(attn_seed)
        proj_bias = None if self.proj_bias is None else self.proj_bias.to(dt)
        out = shifted_window_attention(
            x.to(dt), self.qkv_kernel.to(dt),
            None if qkv_bias is None else qkv_bias.to(dt),
            self.proj_kernel.to(dt), None if tp is not None else proj_bias,
            rel_bias, self.window_size, heads, self.shift_size,
            attention_dropout=self.attention_dropout,
            deterministic=not self.training, generator=gen,
            logit_scale=logit_scale)
        if tp is not None:
            out = tp.reduce(out)
            if proj_bias is not None:
                out = out + proj_bias
        return self.drop(out, None if seed is None else seed + 1)


class ShiftedWindowAttention(_WindowAttentionBase):
    """Swin window attention holding the qkv/proj kernels and the
    relative-position bias table ((2wh-1)(2ww-1), nH), trunc-normal 0.02.
    ``forward(x, seed)``: ``seed`` is the host integer the dropout masks are
    made from (training with dropout > 0 only)."""

    def __init__(self, dim: int, window_size: Sequence[int],
                 shift_size: Sequence[int], num_heads: int,
                 qkv_bias: bool = True, proj_bias: bool = True,
                 attention_dropout: float = 0.0, dropout: float = 0.0, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dim, window_size, shift_size, num_heads, proj_bias,
                         attention_dropout, dropout, dtype, generator)
        wh, ww = self.window_size
        self.relative_position_bias_table = nn.Parameter(_trunc02(
            torch.empty((2 * wh - 1) * (2 * ww - 1), num_heads,
                        dtype=PARAM_DTYPE), generator))
        self.qkv_bias = (nn.Parameter(torch.zeros(3 * dim, dtype=PARAM_DTYPE))
                         if qkv_bias else None)

    def forward(self, x: torch.Tensor, seed: Optional[int] = None
                ) -> torch.Tensor:
        rel_bias = self._gather_bias(self.relative_position_bias_table)
        return self._attend(x, self.qkv_bias, rel_bias, seed)


class ShiftedWindowAttentionV2(_WindowAttentionBase):
    """SwinV2 window attention: cosine similarity with a learned per-head
    temperature (clamped at 100) and a continuous relative position bias
    from a 2→512→nH MLP over log-spaced coordinates, squashed to (0, 16) by
    16·sigmoid. The MLP runs in fp32 whatever the model dtype. The k
    projection carries no bias: ``q_bias`` and ``v_bias`` are learned and
    the k third is identically zero."""

    def __init__(self, dim: int, window_size: Sequence[int],
                 shift_size: Sequence[int], num_heads: int,
                 qkv_bias: bool = True, proj_bias: bool = True,
                 attention_dropout: float = 0.0, dropout: float = 0.0, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dim, window_size, shift_size, num_heads, proj_bias,
                         attention_dropout, dropout, dtype, generator)
        wh, ww = self.window_size
        self.logit_scale = nn.Parameter(torch.full(
            (num_heads, 1, 1), math.log(10.0), dtype=PARAM_DTYPE))
        init = dict(weight_init=_trunc02, generator=generator)
        self.cpb_fc1 = Dense(2, 512, dtype=torch.float32, bias_init=zeros_,
                             **init)
        self.cpb_fc2 = Dense(512, num_heads, bias=False, dtype=torch.float32,
                             **init)
        self.q_bias = (nn.Parameter(torch.zeros(dim, dtype=PARAM_DTYPE))
                       if qkv_bias else None)
        self.v_bias = (nn.Parameter(torch.zeros(dim, dtype=PARAM_DTYPE))
                       if qkv_bias else None)
        self.register_buffer(
            "_coords", torch.from_numpy(
                relative_coords_table(wh, ww).astype(np.float32)),
            persistent=False)

    def forward(self, x: torch.Tensor, seed: Optional[int] = None
                ) -> torch.Tensor:
        table = self.cpb_fc2(torch.relu(self.cpb_fc1(self._coords)))
        rel_bias = 16.0 * torch.sigmoid(
            self._gather_bias(table.reshape(-1, self.num_heads)))
        qkv_bias = None
        if self.q_bias is not None:
            qkv_bias = torch.cat(
                [self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
            if self.tp is not None:
                qkv_bias = self.tp.copy(qkv_bias).index_select(
                    0, self.tp.blocks(self.dim, 3).to(qkv_bias.device))
        return self._attend(x, qkv_bias, rel_bias, seed,
                            logit_scale=self.logit_scale)


def _space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """2×2 space-to-depth with the reference's channel order x0..x3 =
    (even, even), (odd, even), (even, odd), (odd, odd) rows/columns; odd
    maps are zero-padded at the bottom and right."""
    _, h, w, _ = x.shape
    if h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    return torch.cat([x[:, 0::2, 0::2, :], x[:, 1::2, 0::2, :],
                      x[:, 0::2, 1::2, :], x[:, 1::2, 1::2, :]], dim=-1)


class PatchMerging(nn.Module):
    """2×2 space-to-depth → LN(4C, eps 1e-5) → Linear(4C → 2C); input
    (B, H, W, C), NHWC."""

    def __init__(self, dim: int, *, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5, dtype=dtype)
        self.reduction = Dense(
            4 * dim, 2 * dim, dtype=dtype, bias_init=zeros_,
            weight_init=_trunc02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.reduction(self.norm(_space_to_depth(x)))


class PatchMergingV2(nn.Module):
    """SwinV2 merge order: 2×2 space-to-depth → Linear(4C → 2C) →
    LN(2C, eps 1e-5)."""

    def __init__(self, dim: int, *, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.reduction = Dense(
            4 * dim, 2 * dim, dtype=dtype, bias_init=zeros_,
            weight_init=_trunc02, generator=generator)
        self.norm = LayerNorm(2 * dim, eps=1e-5, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.reduction(_space_to_depth(x)))
