"""Pyramid Vision Transformer.

Counterpart of ``vision_transformers_tpu/models/image_classification/
pvt.py``: four stages, each a conv patch embed (as a matmul) + LN returning
(tokens, (H, W)), a learned per-stage position embedding (bilinearly resized
when the runtime grid differs from the configured one), spatial-reduction
attention blocks (sr_ratios [8, 4, 2, 1]), a drop-path schedule that runs
over the cumulative block index, a CLS token prepended only in the last
stage, final LN and a CLS head. Every LayerNorm has eps 1e-6. Inputs are
NHWC.

Module names mirror the JAX params tree (``patch_embedding{i}``,
``position_embedding{i}``, ``cls_token``, ``block{i}_{j}.{norm1,attn,norm2,
mlp}``, ``norm``, ``head``; stages count from 1), so
``utils.port_jax.pvt_state_dict_from_jax`` is a rename and a transpose.
Attention runs through the split-head kernel with Sq != Sk
(``ops/sra.py``), forward and backward.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vision_transformers_tpu_torch.core.dtypes import (
    DeviceLike,
    DtypeLike,
    as_dtype,
    dtype_name,
    resolve_device,
)
from vision_transformers_tpu_torch.core.initializers import trunc_normal_, zeros_
from vision_transformers_tpu_torch.models.image_classification.base import (
    TrainableModel,
    draw_block_seeds,
)
from vision_transformers_tpu_torch.ops.layers import (
    Dense,
    DropPath,
    Dropout,
    LayerNorm,
)
from vision_transformers_tpu_torch.ops.mlp import Mlp
from vision_transformers_tpu_torch.ops.patch_embed import PatchEmbed
from vision_transformers_tpu_torch.ops.sra import SpatialReductionAttention


class PVTBlock(nn.Module):
    """x + DP(SRA(LN x)); x + DP(MLP(LN x)) on (B, N, C) tokens.
    ``forward(x, grid, seed)``: the block's masks come from seed .. seed + 5."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, sr_ratio: int = 1,
                 num_cls_tokens: int = 0, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.attn = SpatialReductionAttention(
            dim, num_heads, sr_ratio=sr_ratio, qkv_bias=qkv_bias,
            qk_scale=qk_scale, attn_drop=attn_drop, proj_drop=drop,
            num_cls_tokens=num_cls_tokens, dtype=dtype, generator=generator)
        self.norm2 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.mlp = Mlp(dim, hidden_dim=int(dim * mlp_ratio), dropout=drop,
                       dtype=dtype, generator=generator)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, grid, seed: Optional[int] = None
                ) -> torch.Tensor:
        sub = (lambda i: None) if seed is None else (lambda i: seed + i)
        x = x + self.drop_path(self.attn(self.norm1(x), grid, seed), sub(4))
        return x + self.drop_path(self.mlp(self.norm2(x), sub(2)), sub(5))


class PVT(nn.Module, TrainableModel):
    """PVT classifier with the JAX package's constructor arguments, plus
    ``device`` (default CUDA; raises without one unless ``device="cpu"``)
    and ``seed`` for the initial weights. ``num_classes=0`` returns the
    post-norm CLS feature. ``config`` holds the kwargs that rebuild it."""

    def __init__(self, image_size: int = 32, patch_size: int = 16,
                 in_channels: int = 3, num_classes: int = 100,
                 embed_dims: Optional[Sequence[int]] = None,
                 num_heads: Optional[Sequence[int]] = None,
                 mlp_ratios: Optional[Sequence[float]] = None,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0,
                 depths: Optional[Sequence[int]] = None,
                 sr_ratios: Optional[Sequence[int]] = None,
                 num_stages: int = 4, dtype: DtypeLike = torch.float32, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        dtype = as_dtype(dtype)
        embed_dims = list(embed_dims or [64, 128, 256, 512])
        num_heads = list(num_heads or [1, 2, 4, 8])
        mlp_ratios = list(mlp_ratios or [4, 4, 4, 4])
        depths = list(depths or [3, 4, 6, 3])
        sr_ratios = list(sr_ratios or [8, 4, 2, 1])
        self.config: Dict[str, Any] = dict(
            image_size=image_size, patch_size=patch_size,
            in_channels=in_channels, num_classes=num_classes,
            embed_dims=embed_dims, num_heads=num_heads, mlp_ratios=mlp_ratios,
            qkv_bias=qkv_bias, qk_scale=qk_scale, drop_rate=drop_rate,
            attn_drop_rate=attn_drop_rate, drop_path_rate=drop_path_rate,
            depths=depths, sr_ratios=sr_ratios, num_stages=num_stages,
            dtype=dtype_name(dtype))
        self.embed_dims, self.depths = embed_dims, depths
        self.num_stages = num_stages
        self.has_dropout = (drop_rate > 0.0 or attn_drop_rate > 0.0
                            or drop_path_rate > 0.0)
        gen = torch.Generator().manual_seed(seed)
        self.dropout_generator = torch.Generator().manual_seed(seed)
        self.pos_drop = Dropout(drop_rate)

        dpr = np.linspace(0, drop_path_rate, sum(depths))
        last = num_stages - 1
        self.canon: List[int] = []  # the configured grid side of each stage
        cur = 0
        for i in range(num_stages):
            self.add_module(f"patch_embedding{i + 1}", PatchEmbed(
                embed_dims[i], patch_size if i == 0 else 2,
                in_channels if i == 0 else embed_dims[i - 1], norm=True,
                dtype=dtype, generator=gen))
            ncls = 1 if i == last else 0
            if ncls:
                self.cls_token = nn.Parameter(trunc_normal_(
                    torch.empty(1, 1, embed_dims[i]), 0.02, gen))
            canon = (image_size // patch_size if i == 0
                     else (image_size // (2 ** (i + 1))) // 2)
            self.canon.append(canon)
            self.register_parameter(
                f"position_embedding{i + 1}", nn.Parameter(trunc_normal_(
                    torch.empty(1, canon * canon + ncls, embed_dims[i]), 0.02,
                    gen)))
            for j in range(depths[i]):
                self.add_module(f"block{i + 1}_{j}", PVTBlock(
                    embed_dims[i], num_heads[i], mlp_ratio=mlp_ratios[i],
                    qkv_bias=qkv_bias, qk_scale=qk_scale, drop=drop_rate,
                    attn_drop=attn_drop_rate, drop_path=float(dpr[cur + j]),
                    sr_ratio=sr_ratios[i], num_cls_tokens=ncls, dtype=dtype,
                    generator=gen))
            cur += depths[i]
        self.norm = LayerNorm(embed_dims[last], eps=1e-6, dtype=dtype)
        self.head = (Dense(embed_dims[last], num_classes, dtype=dtype,
                           weight_init=trunc_normal_, bias_init=zeros_,
                           generator=gen) if num_classes > 0 else None)
        self.to(device)
        self.eval()  # the JAX package's default is deterministic=True

    def _pos_embed(self, i: int, h: int, w: int, ncls: int) -> torch.Tensor:
        """Stage i's position embedding for an (h, w) grid: the grid part is
        resized bilinearly (half-pixel centres, antialiased when shrinking,
        as ``jax.image.resize``) when the grid is not the configured one."""
        pos = getattr(self, f"position_embedding{i + 1}")
        canon = self.canon[i]
        if canon == h and canon == w:
            return pos
        pos_cls, pos_grid = pos[:, :ncls], pos[:, ncls:]
        dim = pos.shape[-1]
        pos_grid = F.interpolate(
            pos_grid.reshape(1, canon, canon, dim).permute(0, 3, 1, 2),
            size=(h, w), mode="bilinear", align_corners=False, antialias=True)
        pos_grid = pos_grid.permute(0, 2, 3, 1).reshape(1, h * w, dim)
        return torch.cat([pos_cls, pos_grid], dim=1)

    def forward_features(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) images → (B, C') post-norm CLS feature."""
        b = images.shape[0]
        seeds = draw_block_seeds(self, sum(self.depths) + self.num_stages)
        x, grid, cur = images, None, 0
        for i in range(self.num_stages):
            if i > 0:  # fold tokens back to a feature map
                x = x.reshape(b, grid[0], grid[1], self.embed_dims[i - 1])
            tokens, grid = getattr(self, f"patch_embedding{i + 1}")(x)
            ncls = 1 if i == self.num_stages - 1 else 0
            if ncls:
                cls = self.cls_token.to(tokens.dtype).expand(b, 1, -1)
                tokens = torch.cat([cls, tokens], dim=1)
            tokens = tokens + self._pos_embed(i, *grid, ncls).to(tokens.dtype)
            tokens = self.pos_drop(tokens, seeds[sum(self.depths) + i])
            for j in range(self.depths[i]):
                tokens = getattr(self, f"block{i + 1}_{j}")(
                    tokens, grid, seeds[cur + j])
            cur += self.depths[i]
            x = tokens
        return self.norm(x)[:, 0]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        feats = self.forward_features(images)
        return feats if self.head is None else self.head(feats)
