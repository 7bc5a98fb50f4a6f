"""Twins-SVT.

Counterpart of ``vision_transformers_tpu/models/image_classification/
twins_svt.py``: per-stage conv patch embed (as a matmul) + LN, blocks that
alternate **LSA** (locally-grouped window attention: even blocks, window
``wss[k]``) and **GSA** (global sub-sampled attention = SRA with
``sr_ratios[k]``: odd blocks), a PosCNN position-encoding generator after
each stage's first block, final LN → average over tokens → head. Every
LayerNorm has eps 1e-6. Inputs are NHWC.

LSA is ``shifted_window_attention`` without shift or relative bias and with
``mask_padding=True`` (edge windows of a grid the window does not divide are
padded and the padded keys masked), so it runs through the window kernels
and their shared backward; GSA is ``ops/sra.py`` through the split-head
kernel. ``PosCNN`` is a depthwise 3×3 convolution, which the JAX package
leaves to XLA and this port to ``F.conv2d``.

Module names mirror the JAX params tree (``patch_embed{k}``,
``block{k}_{j}.{norm1,attn,norm2,mlp}``, ``pos_block{k}.proj``, ``norm``,
``head``; LSA's raw parameters are ``qkv_kernel``, ``qkv_bias_p``,
``proj_kernel``, ``proj_bias_p`` in flax's (in, out) layout), so
``utils.port_jax.twins_state_dict_from_jax`` is a rename and a transpose.
"""

from __future__ import annotations

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
from vision_transformers_tpu_torch.ops.windows import shifted_window_attention
from vision_transformers_tpu_torch.parallel.mesh import shard_tensor


class PosCNN(nn.Module):
    """Twins PEG: depthwise 3×3 conv (SAME padding, with bias) over the
    token grid, residual add. ``weight`` is torch's (C, 1, 3, 3): flax's
    (3, 3, 1, C) kernel transposed; initialised as flax's ``nn.Conv``
    default (LeCun normal over a fan-in of 9, zero bias)."""

    def __init__(self, dim: int, *, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        proj = nn.Module()
        proj.weight = nn.Parameter(trunc_normal_(
            torch.empty(dim, 1, 3, 3, dtype=PARAM_DTYPE), (1.0 / 9.0) ** 0.5,
            generator))
        proj.bias = nn.Parameter(torch.zeros(dim, dtype=PARAM_DTYPE))
        self.proj = proj

    def forward(self, x: torch.Tensor, grid) -> torch.Tensor:
        b, n, c = x.shape
        h, w = grid
        g = x.to(self.dtype).reshape(b, h, w, c).permute(0, 3, 1, 2)
        y = F.conv2d(g, self.proj.weight.to(self.dtype),
                     self.proj.bias.to(self.dtype), padding=1, groups=c)
        return (y + g).permute(0, 2, 3, 1).reshape(b, n, c)


class GroupAttention(nn.Module):
    """LSA: window attention without shift or relative bias, padded edge
    windows masked. ``forward(x, grid, seed)`` as ``SpatialReductionAttention``.
    Under tensor parallelism (``parallel.shard_params``) ``tp`` is set:
    ``qkv_kernel`` holds this rank's heads' columns of q, k and v and
    ``proj_kernel`` their rows; the biases stay whole (no rule shards them,
    as in the JAX package) and each rank reads its part of ``qkv_bias_p``."""

    tp = None

    def __init__(self, dim: int, num_heads: int, ws: int,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads, self.ws = num_heads, ws
        self.attn_drop = attn_drop
        self.dtype = dtype
        self.qkv_kernel = nn.Parameter(trunc_normal_(
            torch.empty(dim, 3 * dim, dtype=PARAM_DTYPE), 0.02, generator))
        self.qkv_bias_p = (nn.Parameter(torch.zeros(3 * dim, dtype=PARAM_DTYPE))
                           if qkv_bias else None)
        self.proj_kernel = nn.Parameter(trunc_normal_(
            torch.empty(dim, dim, dtype=PARAM_DTYPE), 0.02, generator))
        self.proj_bias_p = nn.Parameter(torch.zeros(dim, dtype=PARAM_DTYPE))
        self.drop = Dropout(proj_drop)

    def tp_divides(self, size: int) -> bool:
        return self.num_heads % size == 0

    def tp_shard(self, tp) -> None:
        self.qkv_kernel = shard_tensor(self.qkv_kernel, tp, 1, parts=3)
        self.proj_kernel = shard_tensor(self.proj_kernel, tp, 0)
        self.tp = tp

    def forward(self, x: torch.Tensor, grid, seed: Optional[int] = None
                ) -> torch.Tensor:
        b, n, c = x.shape
        h, w = grid
        dt = self.dtype
        x = x.reshape(b, h, w, c)
        heads, attn_seed, tp = self.num_heads, seed, self.tp
        qkv_bias = self.qkv_bias_p
        if tp is not None:
            x = tp.copy(x)
            heads //= tp.size
            attn_seed = tp.seed(seed)
            if qkv_bias is not None:
                qkv_bias = tp.copy(qkv_bias).index_select(
                    0, tp.blocks(c, 3).to(qkv_bias.device))
        gen = None
        if self.training and self.attn_drop > 0.0:
            if seed is None:
                raise ValueError(
                    "attention dropout in training mode needs a seed")
            gen = torch.Generator().manual_seed(attn_seed)
        proj_bias = self.proj_bias_p.to(dt)
        out = shifted_window_attention(
            x.to(dt), self.qkv_kernel.to(dt),
            None if qkv_bias is None else qkv_bias.to(dt),
            self.proj_kernel.to(dt), None if tp is not None else proj_bias,
            None, (self.ws, self.ws), heads, (0, 0),
            attention_dropout=self.attn_drop,
            deterministic=not self.training, generator=gen,
            mask_padding=True)
        if tp is not None:
            out = tp.reduce(out) + proj_bias
        return self.drop(out.reshape(b, n, c), None if seed is None
                         else seed + 1)


class GroupBlock(nn.Module):
    """LSA (ws > 1) or GSA (ws == 1) + MLP, pre-LN, drop-path.
    ``forward(x, grid, seed)``: the block's masks come from seed .. seed + 5."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, sr_ratio: int = 1, ws: int = 1, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        common = dict(qkv_bias=qkv_bias, qk_scale=qk_scale,
                      attn_drop=attn_drop, proj_drop=drop, dtype=dtype,
                      generator=generator)
        if ws == 1:
            self.attn = SpatialReductionAttention(dim, num_heads,
                                                  sr_ratio=sr_ratio, **common)
        else:
            self.attn = GroupAttention(dim, num_heads, ws=ws, **common)
        self.norm2 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.mlp = Mlp(dim, hidden_dim=int(dim * mlp_ratio), dropout=drop,
                       dtype=dtype, generator=generator)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, grid, seed: Optional[int] = None
                ) -> torch.Tensor:
        sub = (lambda i: None) if seed is None else (lambda i: seed + i)
        x = x + self.drop_path(self.attn(self.norm1(x), grid, seed), sub(4))
        return x + self.drop_path(self.mlp(self.norm2(x), sub(2)), sub(5))


class TwinSVT(nn.Module, TrainableModel):
    """Twins-SVT classifier with the JAX package's constructor arguments,
    plus ``device`` (default CUDA; raises without one unless
    ``device="cpu"``) and ``seed`` for the initial weights.
    ``num_classes=0`` returns the pooled feature. ``config`` holds the
    kwargs that rebuild it."""

    def __init__(self, img_size: int = 32, patch_size: int = 4,
                 in_chans: int = 3, num_classes: int = 100,
                 embed_dims: Optional[Sequence[int]] = None,
                 num_heads: Optional[Sequence[int]] = None,
                 mlp_ratios: Optional[Sequence[float]] = None,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0,
                 depths: Optional[Sequence[int]] = None,
                 sr_ratios: Optional[Sequence[int]] = None,
                 wss: Optional[Sequence[int]] = None,
                 dtype: DtypeLike = torch.float32, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        dtype = as_dtype(dtype)
        embed_dims = list(embed_dims or [64, 128, 256])
        num_heads = list(num_heads or [1, 2, 4])
        mlp_ratios = list(mlp_ratios or [4, 4, 4])
        depths = list(depths or [4, 4, 4])
        sr_ratios = list(sr_ratios or [4, 2, 1])
        wss = list(wss or [7, 7, 7])
        self.config: Dict[str, Any] = dict(
            img_size=img_size, patch_size=patch_size, in_chans=in_chans,
            num_classes=num_classes, embed_dims=embed_dims,
            num_heads=num_heads, mlp_ratios=mlp_ratios, qkv_bias=qkv_bias,
            qk_scale=qk_scale, drop_rate=drop_rate,
            attn_drop_rate=attn_drop_rate, drop_path_rate=drop_path_rate,
            depths=depths, sr_ratios=sr_ratios, wss=wss,
            dtype=dtype_name(dtype))
        self.embed_dims, self.depths = embed_dims, depths
        self.has_dropout = (drop_rate > 0.0 or attn_drop_rate > 0.0
                            or drop_path_rate > 0.0)
        gen = torch.Generator().manual_seed(seed)
        self.dropout_generator = torch.Generator().manual_seed(seed)
        self.pos_drop = Dropout(drop_rate)

        dpr = np.linspace(0, drop_path_rate, sum(depths))
        cur = 0
        for k in range(len(depths)):
            self.add_module(f"patch_embed{k}", PatchEmbed(
                embed_dims[k], patch_size if k == 0 else 2,
                in_chans if k == 0 else embed_dims[k - 1], norm=True,
                dtype=dtype, generator=gen))
            for j in range(depths[k]):
                self.add_module(f"block{k}_{j}", GroupBlock(
                    embed_dims[k], num_heads[k], mlp_ratio=mlp_ratios[k],
                    qkv_bias=qkv_bias, qk_scale=qk_scale, drop=drop_rate,
                    attn_drop=attn_drop_rate, drop_path=float(dpr[cur + j]),
                    sr_ratio=sr_ratios[k], ws=1 if j % 2 == 1 else wss[k],
                    dtype=dtype, generator=gen))
            self.add_module(f"pos_block{k}", PosCNN(embed_dims[k], dtype=dtype,
                                                    generator=gen))
            cur += depths[k]
        self.norm = LayerNorm(embed_dims[-1], eps=1e-6, dtype=dtype)
        self.head = (Dense(embed_dims[-1], num_classes, dtype=dtype,
                           weight_init=trunc_normal_, bias_init=zeros_,
                           generator=gen) if num_classes > 0 else None)
        self.to(device)
        self.eval()  # the JAX package's default is deterministic=True

    def forward_features(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) images → (B, C') feature averaged over tokens."""
        b = images.shape[0]
        stages = len(self.depths)
        seeds = draw_block_seeds(self, sum(self.depths) + stages)
        x, grid, cur = images, None, 0
        for k in range(stages):
            if k > 0:  # fold tokens back to a feature map
                x = x.reshape(b, grid[0], grid[1], self.embed_dims[k - 1])
            tokens, grid = getattr(self, f"patch_embed{k}")(x)
            tokens = self.pos_drop(tokens, seeds[sum(self.depths) + k])
            for j in range(self.depths[k]):
                tokens = getattr(self, f"block{k}_{j}")(tokens, grid,
                                                        seeds[cur + j])
                if j == 0:
                    tokens = getattr(self, f"pos_block{k}")(tokens, grid)
            cur += self.depths[k]
            x = tokens
        x = self.norm(x)
        return x.float().mean(dim=1).to(x.dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        feats = self.forward_features(images)
        return feats if self.head is None else self.head(feats)
