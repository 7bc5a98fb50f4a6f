"""TNT: Transformer-in-Transformer.

Counterpart of ``vision_transformers_tpu/models/image_classification/
tnt.py``. Two token granularities: "words" (inner tokens from a k7 conv,
padding 3, stride ``inner_stride``, over each p×p patch) and "sentences"
(outer tokens). Each block runs inner attention + MLP over the words,
projects the words of each patch into its sentence token (all but the class
token), then outer attention + MLP with optional SE gating. Learned inner and
outer position embeddings, trunc-normal 0.02. Inputs are NHWC.

The attention (``TNTAttention``: separate ``qk`` and ``v`` projections) goes
through ``ops.attention.dot_product_attention`` with q, k and v contiguous:
on the card the split-head kernels of rows 2 and 6 (row 5 with
``attention_dropout`` > 0), at the constructor defaults at head dim 128
(outer, S 17) and 12 (inner, S 4).

Module names mirror the JAX params tree (``patch_proj``, ``inner_pos``,
``proj_norm1``, ``proj``, ``proj_norm2``, ``cls_token``, ``outer_pos``,
``block{i}``, ``norm``, ``head``), so ``utils.port_jax.tnt_state_dict_from_jax``
is a rename and a transpose; ``patch_proj.weight`` is torch's (out, in, 7, 7),
flax's (7, 7, in, out) kernel transposed.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vision_transformers_tpu_torch.core.dtypes import (
    PARAM_DTYPE,
    DeviceLike,
    DtypeLike,
    as_dtype,
    dtype_name,
    resolve_device,
)
from vision_transformers_tpu_torch.core.initializers import (
    trunc_normal_,
    zeros_,
)
from vision_transformers_tpu_torch.models.image_classification.base import (
    TrainableModel,
    draw_block_seeds,
)
from vision_transformers_tpu_torch.ops.attention import dot_product_attention
from vision_transformers_tpu_torch.ops.layers import (
    Dense,
    DropPath,
    Dropout,
    LayerNorm,
)
from vision_transformers_tpu_torch.ops.mlp import Mlp


def _dense(n_in: int, n_out: int, dtype, gen, bias: bool = True) -> Dense:
    return Dense(n_in, n_out, bias=bias, dtype=dtype, weight_init=trunc_normal_,
                 bias_init=zeros_, generator=gen)


def _param(shape, gen) -> nn.Parameter:
    return nn.Parameter(trunc_normal_(torch.empty(*shape, dtype=PARAM_DTYPE),
                                      0.02, gen))


class TNTAttention(nn.Module):
    """Separate QK (dim → 2·hidden) and V (dim → dim) projections, then the
    split-head attention and an output projection. ``forward(x, seed)``:
    in training, the attention dropout's mask comes from ``seed`` and the
    output dropout's from ``seed + 1``."""

    def __init__(self, dim: int, hidden_dim: int, num_heads: int = 8,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_dim, self.num_heads = hidden_dim, num_heads
        self.scale = qk_scale or (hidden_dim // num_heads) ** -0.5
        self.attn_drop = attn_drop
        self.qk = _dense(dim, 2 * hidden_dim, dtype, generator, qkv_bias)
        self.v = _dense(dim, dim, dtype, generator, qkv_bias)
        self.proj = _dense(dim, dim, dtype, generator)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x: torch.Tensor, seed: Optional[int] = None
                ) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        qk = self.qk(x).reshape(b, n, 2, h, self.hidden_dim // h) \
            .permute(2, 0, 3, 1, 4)
        q, k = qk[0].contiguous(), qk[1].contiguous()
        v = self.v(x).reshape(b, n, h, c // h).transpose(1, 2).contiguous()
        drop = self.attn_drop if self.training else 0.0
        gen = (torch.Generator().manual_seed(seed) if drop > 0.0 else None)
        out = dot_product_attention(q, k, v, scale=self.scale,
                                    dropout_rate=drop, generator=gen)
        out = self.proj(out.transpose(1, 2).reshape(b, n, c))
        return self.proj_drop(out, None if seed is None else seed + 1)


class SE(nn.Module):
    """Squeeze-excite over tokens: mean → LN → Dense → ReLU → Dense → tanh
    gate on the input. Submodules carry flax's automatic names."""

    def __init__(self, dim: int, hidden_ratio: float = 1.0, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = int(dim * hidden_ratio)
        self.LayerNorm_0 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.Dense_0 = _dense(dim, hidden, dtype, generator)
        self.Dense_1 = _dense(hidden, dim, dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.LayerNorm_0(x.mean(dim=1, keepdim=True))
        a = self.Dense_1(torch.relu(self.Dense_0(a)))
        return torch.tanh(a) * x


class TNTBlock(nn.Module):
    """Inner transformer over words (skipped when ``inner_dim`` <= 0), words
    folded into their sentence token, outer transformer (+ SE)."""

    def __init__(self, outer_dim: int, inner_dim: int, outer_num_heads: int,
                 inner_num_heads: int, num_words: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, se: int = 0, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        attn = dict(qkv_bias=qkv_bias, qk_scale=qk_scale, attn_drop=attn_drop,
                    proj_drop=drop, **kw)
        self.inner_dim = inner_dim
        self.drop_path = DropPath(drop_path)
        if inner_dim > 0:
            self.inner_norm1 = LayerNorm(inner_dim, eps=1e-6, dtype=dtype)
            self.inner_attn = TNTAttention(inner_dim, inner_dim,
                                           inner_num_heads, **attn)
            self.inner_norm2 = LayerNorm(inner_dim, eps=1e-6, dtype=dtype)
            self.inner_mlp = Mlp(inner_dim, int(inner_dim * mlp_ratio),
                                 inner_dim, dropout=drop, **kw)
            words = num_words * inner_dim
            self.proj_norm1 = LayerNorm(words, eps=1e-6, dtype=dtype)
            self.proj = _dense(words, outer_dim, dtype, generator, bias=False)
            self.proj_norm2 = LayerNorm(outer_dim, eps=1e-6, dtype=dtype)
        self.outer_norm1 = LayerNorm(outer_dim, eps=1e-6, dtype=dtype)
        self.outer_attn = TNTAttention(outer_dim, outer_dim, outer_num_heads,
                                       **attn)
        self.outer_norm2 = LayerNorm(outer_dim, eps=1e-6, dtype=dtype)
        self.outer_mlp = Mlp(outer_dim, int(outer_dim * mlp_ratio), outer_dim,
                             dropout=drop, **kw)
        self.se_layer = SE(outer_dim, 0.25, **kw) if se > 0 else None

    def forward(self, inner: torch.Tensor, outer: torch.Tensor,
                seed: Optional[int] = None):
        """``seed`` (training): this block's masks come from seed .. seed +
        11."""
        sub = (lambda i: None) if seed is None else (lambda i: seed + i)
        dp = self.drop_path
        if self.inner_dim > 0:
            inner = inner + dp(self.inner_attn(self.inner_norm1(inner),
                                               sub(0)), sub(2))
            inner = inner + dp(self.inner_mlp(self.inner_norm2(inner),
                                              sub(3)), sub(5))
            b, n1, _ = outer.shape
            words = self.proj_norm2(self.proj(self.proj_norm1(
                inner.reshape(b, n1 - 1, -1))))
            outer = torch.cat([outer[:, :1], outer[:, 1:] + words], dim=1)
        outer = outer + dp(self.outer_attn(self.outer_norm1(outer), sub(6)),
                           sub(8))
        y = self.outer_mlp(self.outer_norm2(outer), sub(9))
        if self.se_layer is not None:
            y = y + self.se_layer(y)
        return inner, outer + dp(y, sub(11))


class TNT(nn.Module, TrainableModel):
    """TNT classifier with the JAX package's constructor arguments (the
    reference's defaults: image 32, patch 8, outer 512, inner 48, 7 layers,
    4 + 4 heads), plus ``device`` (default CUDA; raises without one unless
    ``device="cpu"``) and ``seed`` for the initial weights. ``config`` holds
    the kwargs that rebuild it."""

    def __init__(self, image_size: int = 32, patch_size: int = 8,
                 num_classes: int = 100, outer_dim: int = 512,
                 inner_dim: int = 48, num_layers: int = 7,
                 outer_num_heads: int = 4, inner_num_heads: int = 4,
                 mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, dropout: float = 0.0,
                 attention_dropout: float = 0.0, drop_path_rate: float = 0.0,
                 inner_stride: int = 4, se: int = 0,
                 inner_free_layers: Sequence[int] = (),
                 dtype: DtypeLike = torch.float32, in_channels: int = 3, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        dtype = as_dtype(dtype)
        self.config: Dict[str, Any] = dict(
            image_size=image_size, patch_size=patch_size,
            num_classes=num_classes, outer_dim=outer_dim, inner_dim=inner_dim,
            num_layers=num_layers, outer_num_heads=outer_num_heads,
            inner_num_heads=inner_num_heads, mlp_ratio=mlp_ratio,
            qkv_bias=qkv_bias, qk_scale=qk_scale, dropout=dropout,
            attention_dropout=attention_dropout,
            drop_path_rate=drop_path_rate, inner_stride=inner_stride, se=se,
            inner_free_layers=list(inner_free_layers), dtype=dtype_name(dtype),
            in_channels=in_channels)
        self.image_size, self.patch_size = image_size, patch_size
        self.inner_stride, self.inner_dim = inner_stride, inner_dim
        self.outer_dim, self.num_layers = outer_dim, num_layers
        self.num_classes, self.dtype = num_classes, dtype
        self.has_dropout = (dropout > 0.0 or attention_dropout > 0.0
                            or drop_path_rate > 0.0)
        gen = torch.Generator().manual_seed(seed)
        self.dropout_generator = torch.Generator().manual_seed(seed)
        n_patches = (image_size // patch_size) ** 2
        words_side = -(-patch_size // inner_stride)  # ceil
        num_words = words_side * words_side
        patch_proj = nn.Module()  # flax nn.Conv: LeCun normal, zero bias
        patch_proj.weight = nn.Parameter(trunc_normal_(
            torch.empty(inner_dim, in_channels, 7, 7, dtype=PARAM_DTYPE),
            math.sqrt(1.0 / (in_channels * 49)), gen))
        patch_proj.bias = nn.Parameter(torch.zeros(inner_dim,
                                                   dtype=PARAM_DTYPE))
        self.patch_proj = patch_proj
        self.inner_pos = _param((1, num_words, inner_dim), gen)
        self.proj_norm1 = LayerNorm(num_words * inner_dim, eps=1e-6,
                                    dtype=dtype)
        self.proj = _dense(num_words * inner_dim, outer_dim, dtype, gen)
        self.proj_norm2 = LayerNorm(outer_dim, eps=1e-6, dtype=dtype)
        self.cls_token = _param((1, 1, outer_dim), gen)
        self.outer_pos = _param((1, n_patches + 1, outer_dim), gen)
        self.pos_drop = Dropout(dropout)
        dpr = np.linspace(0, drop_path_rate, num_layers)
        for i in range(num_layers):
            self.add_module(f"block{i}", TNTBlock(
                outer_dim, -1 if i in inner_free_layers else inner_dim,
                outer_num_heads, inner_num_heads, num_words, mlp_ratio,
                qkv_bias, qk_scale, dropout, attention_dropout, float(dpr[i]),
                se, dtype=dtype, generator=gen))
        self.norm = LayerNorm(outer_dim, eps=1e-6, dtype=dtype)
        self.head = (_dense(outer_dim, num_classes, dtype, gen)
                     if num_classes > 0 else None)
        self.to(device)
        self.eval()  # the JAX package's default is deterministic=True

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b, h, w, c = images.shape
        p = self.patch_size
        if h != self.image_size or w != self.image_size:
            raise ValueError("Input Image and Expected size doesn't match")
        n_patches = (h // p) * (w // p)
        dt = self.dtype
        # words: split into p×p patches, then the k7 p3 conv per patch
        x = images.to(dt).reshape(b, h // p, p, w // p, p, c) \
            .permute(0, 1, 3, 2, 4, 5).reshape(b * n_patches, p, p, c)
        inner = F.conv2d(x.permute(0, 3, 1, 2), self.patch_proj.weight.to(dt),
                         self.patch_proj.bias.to(dt), self.inner_stride, 3)
        inner = inner.permute(0, 2, 3, 1).reshape(b * n_patches, -1,
                                                  self.inner_dim)
        inner = inner + self.inner_pos.to(inner.dtype)
        outer = self.proj_norm2(self.proj(self.proj_norm1(
            inner.reshape(b, n_patches, -1))))
        cls = self.cls_token.to(outer.dtype).expand(b, 1, self.outer_dim)
        seeds = draw_block_seeds(self, self.num_layers + 1)
        outer = self.pos_drop(
            torch.cat([cls, outer], dim=1) + self.outer_pos.to(outer.dtype),
            seeds[-1])
        for i in range(self.num_layers):
            inner, outer = getattr(self, f"block{i}")(inner, outer, seeds[i])
        feats = self.norm(outer)[:, 0]
        return feats if self.head is None else self.head(feats)
