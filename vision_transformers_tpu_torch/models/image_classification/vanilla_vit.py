"""Vanilla Vision Transformer.

Counterpart of ``vision_transformers_tpu/models/image_classification/
vanilla_vit.py``: patch embed as a matmul, learnable class token, learned
absolute positional embedding N(0, .02), pre-LN encoder blocks
(LN → MHA → dropout → residual; LN → GELU-MLP → residual), final LN and a
zero-initialised CLS head. Inputs are NHWC.

Module names mirror the JAX params tree (``conv_proj.proj``,
``encoder.encoder_layer_{i}.self_attention.qkv``, ...), so
``utils.port_jax.vit_state_dict_from_jax`` is a rename and a transpose.

The JAX package's fused attention sub-block (``USE_FUSED_BLOCK``) is off
there and not ported; training (``train_model``) belongs to a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from vision_transformers_tpu_torch.core.dtypes import (
    DeviceLike,
    DtypeLike,
    as_dtype,
    dtype_name,
    resolve_device,
)
from vision_transformers_tpu_torch.core.initializers import normal_, zeros_
from vision_transformers_tpu_torch.ops.attention import SelfAttention
from vision_transformers_tpu_torch.ops.layers import Dense, LayerNorm
from vision_transformers_tpu_torch.ops.mlp import MLPBlock
from vision_transformers_tpu_torch.ops.patch_embed import PatchEmbed


class EncoderBlock(nn.Module):
    """Pre-LN transformer encoder block."""

    def __init__(self, num_heads: int, hidden_dim: int, mlp_dim: int,
                 dropout: float = 0.0, attention_dropout: float = 0.0, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ln_1 = LayerNorm(hidden_dim, eps=1e-6, dtype=dtype)
        self.self_attention = SelfAttention(
            hidden_dim, num_heads, attention_dropout=attention_dropout,
            dtype=dtype, generator=generator)
        self.drop = nn.Dropout(dropout)
        self.ln_2 = LayerNorm(hidden_dim, eps=1e-6, dtype=dtype)
        self.mlp = MLPBlock(hidden_dim, mlp_dim, dropout=dropout, dtype=dtype,
                            generator=generator)

    def forward(self, x: torch.Tensor, return_weights: bool = False):
        weights = None
        y = self.ln_1(x)
        if return_weights:
            y, weights = self.self_attention(y, return_weights=True)
        else:
            y = self.self_attention(y)
        x = x + self.drop(y)
        out = x + self.mlp(self.ln_2(x))
        if return_weights:
            return out, weights
        return out


class Encoder(nn.Module):
    """Stack of encoder blocks with a learned absolute position embedding.
    Blocks are registered as ``encoder_layer_{i}`` (the JAX names)."""

    def __init__(self, seq_length: int, num_layers: int, num_heads: int,
                 hidden_dim: int, mlp_dim: int, dropout: float = 0.0,
                 attention_dropout: float = 0.0, remat: bool = False, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.remat = remat
        self.pos_embedding = nn.Parameter(normal_(
            torch.empty(1, seq_length, hidden_dim), 0.02, generator))
        self.drop = nn.Dropout(dropout)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"encoder_layer_{i}", EncoderBlock(
                num_heads, hidden_dim, mlp_dim, dropout, attention_dropout,
                dtype=dtype, generator=generator))
        self.ln = LayerNorm(hidden_dim, eps=1e-6, dtype=dtype)

    def forward(self, x: torch.Tensor, return_weights: bool = False):
        x = self.drop(x + self.pos_embedding.to(x.dtype))
        all_weights = []
        for i in range(self.num_layers):
            block = getattr(self, f"encoder_layer_{i}")
            if return_weights:
                x, w = block(x, True)
                all_weights.append(w)
            elif self.remat and self.training:
                # recompute blocks in the backward: FLOPs for activation memory
                x = torch.utils.checkpoint.checkpoint(
                    block, x, use_reentrant=False)
            else:
                x = block(x)
        x = self.ln(x)
        if return_weights:
            return x, all_weights
        return x


class ViT(nn.Module):
    """ViT classifier with the JAX package's constructor arguments, plus
    ``device`` (default CUDA; raises without one unless ``device="cpu"``)
    and ``seed`` for the initial weights. ``dtype`` is the compute dtype;
    parameters are fp32. ``config`` holds the constructor kwargs that
    rebuild the model (serving's manifest stores them)."""

    def __init__(self, image_size: int, patch_size: int, num_layers: int,
                 num_heads: int, hidden_dim: int, mlp_dim: int,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 num_classes: int = 1000, remat: bool = False,
                 dtype: DtypeLike = torch.float32, quant8: bool = False,
                 in_channels: int = 3, *, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        if quant8:
            raise NotImplementedError(
                "int8 serving is not ported yet (ROADMAP.md, queue 1, item 11)")
        if image_size % patch_size:
            raise ValueError("Input shape indivisible by patch size!")
        device = resolve_device(device)
        dtype = as_dtype(dtype)
        self.config: Dict[str, Any] = dict(
            image_size=image_size, patch_size=patch_size,
            num_layers=num_layers, num_heads=num_heads,
            hidden_dim=hidden_dim, mlp_dim=mlp_dim, dropout=dropout,
            attention_dropout=attention_dropout, num_classes=num_classes,
            remat=remat, dtype=dtype_name(dtype), in_channels=in_channels)
        self.hidden_dim = hidden_dim
        gen = torch.Generator().manual_seed(seed)
        seq_length = (image_size // patch_size) ** 2 + 1
        self.conv_proj = PatchEmbed(hidden_dim, patch_size, in_channels,
                                    dtype=dtype, generator=gen)
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.encoder = Encoder(
            seq_length, num_layers, num_heads, hidden_dim, mlp_dim, dropout,
            attention_dropout, remat, dtype=dtype, generator=gen)
        self.head = Dense(hidden_dim, num_classes, dtype=dtype,
                          weight_init=zeros_, bias_init=zeros_)
        self.to(device)
        self.eval()  # the JAX package's default is deterministic=True

    def forward_features(self, images: torch.Tensor,
                         return_weights: bool = False):
        tokens, _ = self.conv_proj(images)
        cls = self.class_token.to(tokens.dtype).expand(
            tokens.shape[0], 1, self.hidden_dim)
        tokens = torch.cat([cls, tokens], dim=1)
        return self.encoder(tokens, return_weights)

    def forward(self, images: torch.Tensor, return_weights: bool = False):
        if return_weights:
            feats, weights = self.forward_features(images, True)
            return self.head(feats[:, 0]), weights
        return self.head(self.forward_features(images)[:, 0])
