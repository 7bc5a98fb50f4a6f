"""Spatial-Reduction Attention (PVT) and Twins' global sub-sampled variant.

Counterpart of ``vision_transformers_tpu/ops/sra.py``: Q from all N tokens,
K/V from tokens spatially reduced by a stride-``sr_ratio`` conv (+ LN), so
attention costs O(N²/r²). The reduction conv is a non-overlapping patch
matmul (kernel == stride): space-to-depth + ``Dense``, as the patch embed.
The attention is the split-head kernel's cross-attention case (Sk = N/r² ≪
Sq) through ``dot_product_attention``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vision_transformers_tpu_torch.core.initializers import trunc_normal_, zeros_
from vision_transformers_tpu_torch.ops.attention import dot_product_attention
from vision_transformers_tpu_torch.ops.layers import Dense, Dropout, LayerNorm
from vision_transformers_tpu_torch.parallel.mesh import (
    ColumnParallelDense,
    RowParallelDense,
)


class SpatialReductionAttention(nn.Module):
    """PVT SRA on (B, N, C) token sequences with grid (H, W).

    ``num_cls_tokens`` leading tokens (PVT's last stage prepends CLS) skip
    the spatial reduction: they go in front of the reduced K/V sequence so
    every query can still attend to them. ``qkv_bias`` governs ``q`` and
    ``kv`` only; ``sr`` and ``proj`` always have a bias.
    ``forward(x, grid, seed)``: ``seed`` feeds the attention dropout (seed)
    and the projection dropout (seed + 1) in training mode. Under tensor
    parallelism (``parallel.shard_params``) ``tp`` is set: ``q`` and ``kv``
    hold this rank's heads (``num_heads`` is its share) and ``proj`` their
    rows; the reduction ``sr`` stays whole.
    """

    tp = None

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 num_cls_tokens: int = 0, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(
                f"dim {dim} should be divided by num_heads {num_heads}.")
        self.dim = dim
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.attn_drop = attn_drop
        self.num_cls_tokens = num_cls_tokens
        init = dict(dtype=dtype, weight_init=trunc_normal_, bias_init=zeros_,
                    generator=generator)
        self.q = Dense(dim, dim, bias=qkv_bias, **init)
        if sr_ratio > 1:
            self.sr = Dense(sr_ratio * sr_ratio * dim, dim, **init)
            self.sr_norm = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.kv = Dense(dim, 2 * dim, bias=qkv_bias, **init)
        self.proj = Dense(dim, dim, **init)
        self.drop = Dropout(proj_drop)

    def tp_divides(self, size: int) -> bool:
        return self.num_heads % size == 0

    def tp_shard(self, tp) -> None:
        self.q = ColumnParallelDense(self.q, tp)
        self.kv = ColumnParallelDense(self.kv, tp, parts=2)
        self.proj = RowParallelDense(self.proj, tp)
        self.num_heads //= tp.size
        self.tp = tp

    def _reduce(self, x: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
        """The K/V input: CLS tokens, then the grid reduced r×r → 1. A grid
        that r does not divide is zero-padded first, so padded cells
        contribute the reduction's bias only."""
        b, _, c = x.shape
        h, w = grid
        r, ncls = self.sr_ratio, self.num_cls_tokens
        cls, g = x[:, :ncls, :], x[:, ncls:, :].reshape(b, h, w, c)
        pad_h, pad_w = (-h) % r, (-w) % r
        if pad_h or pad_w:
            g = F.pad(g, (0, 0, 0, pad_w, 0, pad_h))
        hh, ww = g.shape[1] // r, g.shape[2] // r
        g = g.reshape(b, hh, r, ww, r, c).permute(0, 1, 3, 2, 4, 5)
        g = self.sr_norm(self.sr(g.reshape(b, hh * ww, r * r * c)))
        return torch.cat([cls.to(g.dtype), g], dim=1) if ncls else g

    def forward(self, x: torch.Tensor, grid: Tuple[int, int],
                seed: Optional[int] = None) -> torch.Tensor:
        b, n, _ = x.shape
        heads = self.num_heads
        c = self.q.weight.shape[0]  # the width of this rank's heads
        dh = c // heads
        q = self.q(x).reshape(b, n, heads, dh).transpose(1, 2).contiguous()
        kv_in = self._reduce(x, grid) if self.sr_ratio > 1 else x
        nk = kv_in.shape[1]
        k, v = self.kv(kv_in).reshape(b, nk, 2, heads, dh).permute(
            2, 0, 3, 1, 4).contiguous()

        drop = self.attn_drop if self.training else 0.0
        gen = None
        if drop > 0.0:
            if seed is None:
                raise ValueError(
                    "attention dropout in training mode needs a seed")
            gen = torch.Generator().manual_seed(
                seed if self.tp is None else self.tp.seed(seed))
        out = dot_product_attention(q, k, v, scale=self.scale,
                                    dropout_rate=drop, generator=gen)
        out = self.proj(out.transpose(1, 2).reshape(b, n, c))
        return self.drop(out, None if seed is None else seed + 1)
