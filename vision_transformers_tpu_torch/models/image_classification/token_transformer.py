"""T2T token transformer: an attention block that changes the width, with V
as the skip connection.

Counterpart of ``vision_transformers_tpu/models/image_classification/
token_transformer.py``: qkv projects dim → 3·H·in_dim (no bias; head dim
in_dim), the softmax scale is (dim // H)^-0.5 of the *input* width, the
output is V + proj(attention) (the input has another width, so it cannot be
the skip), then x + DropPath(MLP(LN x)). Attention goes through the
port's dispatcher, so on the card it is the split-head kernel or, above
1.5 M scores (the first T2T stage at 224 px: 3136 tokens), the streaming
kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vision_transformers_tpu_torch.core.initializers import trunc_normal_, zeros_
from vision_transformers_tpu_torch.ops.attention import dot_product_attention
from vision_transformers_tpu_torch.ops.layers import (
    Dense,
    DropPath,
    Dropout,
    LayerNorm,
)
from vision_transformers_tpu_torch.ops.mlp import Mlp


class TokenAttention(nn.Module):
    """``forward(x, seed)``: the attention mask is made from seed, the
    projection's dropout mask from seed + 1 (training mode)."""

    def __init__(self, dim: int, in_dim: int, num_heads: int = 1,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads, self.in_dim = num_heads, in_dim
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.attn_drop = attn_drop
        dense = dict(dtype=dtype, weight_init=trunc_normal_, bias_init=zeros_,
                     generator=generator)
        self.qkv = Dense(dim, 3 * num_heads * in_dim, bias=qkv_bias, **dense)
        self.proj = Dense(num_heads * in_dim, num_heads * in_dim, **dense)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x: torch.Tensor, seed: Optional[int] = None
                ) -> torch.Tensor:
        b, n, _ = x.shape
        h, d = self.num_heads, self.in_dim
        qkv = self.qkv(x).reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in qkv)
        drop = self.attn_drop if self.training else 0.0
        gen = (torch.Generator().manual_seed(seed) if drop > 0.0 else None)
        out = dot_product_attention(q, k, v, scale=self.scale,
                                    dropout_rate=drop, generator=gen)
        out = self.proj(out.transpose(1, 2).reshape(b, n, h * d))
        out = self.proj_drop(out, None if seed is None else seed + 1)
        # V as the skip connection, heads folded back
        return v.transpose(1, 2).reshape(b, n, h * d) + out


class TokenTransformer(nn.Module):
    """attn(LN x) [no residual]; x + DropPath(MLP(LN x)). ``forward(x,
    seed)``: masks from seed .. seed + 4 (training mode)."""

    def __init__(self, dim: int, in_dim: int, num_heads: int = 1,
                 mlp_ratio: float = 1.0, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.attn = TokenAttention(
            dim, in_dim, num_heads, qkv_bias, qk_scale, attn_drop, drop,
            dtype=dtype, generator=generator)
        self.norm2 = LayerNorm(in_dim, eps=1e-6, dtype=dtype)
        self.mlp = Mlp(in_dim, int(in_dim * mlp_ratio), in_dim, drop,
                       dtype=dtype, generator=generator)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, seed: Optional[int] = None
                ) -> torch.Tensor:
        sub = (lambda i: None) if seed is None else (lambda i: seed + i)
        x = self.attn(self.norm1(x), seed)
        return x + self.drop_path(self.mlp(self.norm2(x), sub(2)), sub(4))
