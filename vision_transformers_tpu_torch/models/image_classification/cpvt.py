"""CPVT and CPVT-GAP (Conditional Positional Vision Transformer).

Counterpart of ``vision_transformers_tpu/models/image_classification/
cpvt.py``. No learned absolute position embedding: position information
comes from a depthwise-conv CPE applied once after the class token is
attached, and a PEG (the same module) at the end of every encoder block.
``CPVT`` reads the class token; ``CPVTGAP`` global-average-pools the patch
tokens. The blocks are the standard pre-LN attention and MLP residuals then
the PEG (the JAX package's intended semantics, not the reference's
double-counted residual). Inputs are NHWC.

The attention is the ported ``SelfAttention``: at the ``vit_tiny`` preset
(hidden 256, 4 heads, attention dropout 0.1) the packed kernels of rows 1
and 7 on the card.

Module names mirror the JAX params tree (``conv_proj.proj``,
``class_token``, ``pos_embedding.conv``, ``encoder_layer_{i}`` with
``ln_1``, ``self_attention``, ``ln_2``, ``mlp``, ``peg.conv``; ``ln``,
``head``), so ``utils.port_jax.cpvt_state_dict_from_jax`` is a rename and a
transpose.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from vision_transformers_tpu_torch.core.dtypes import (
    DeviceLike,
    DtypeLike,
    as_dtype,
    dtype_name,
    resolve_device,
)
from vision_transformers_tpu_torch.core.initializers import zeros_
from vision_transformers_tpu_torch.models.image_classification.base import (
    TrainableModel,
    draw_block_seeds,
)
from vision_transformers_tpu_torch.ops.attention import SelfAttention
from vision_transformers_tpu_torch.ops.layers import Dense, Dropout, LayerNorm
from vision_transformers_tpu_torch.ops.mlp import MLPBlock
from vision_transformers_tpu_torch.ops.patch_embed import PatchEmbed
from vision_transformers_tpu_torch.ops.posenc import (
    ConditionalPositionalEncoding,
)


class PEGEncoderBlock(nn.Module):
    """Pre-LN encoder block with a PEG after the MLP residual."""

    def __init__(self, num_heads: int, hidden_dim: int, mlp_dim: int,
                 dropout: float = 0.0, attention_dropout: float = 0.0, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ln_1 = LayerNorm(hidden_dim, eps=1e-6, dtype=dtype)
        self.self_attention = SelfAttention(
            hidden_dim, num_heads, attention_dropout=attention_dropout,
            dtype=dtype, generator=generator)
        self.drop = Dropout(dropout)
        self.ln_2 = LayerNorm(hidden_dim, eps=1e-6, dtype=dtype)
        self.mlp = MLPBlock(hidden_dim, mlp_dim, dropout=dropout, dtype=dtype,
                            generator=generator)
        self.peg = ConditionalPositionalEncoding(hidden_dim, dtype=dtype,
                                                 generator=generator)

    def forward(self, x: torch.Tensor, seed: Optional[int] = None
                ) -> torch.Tensor:
        """``seed`` (training): the masks come from seed .. seed + 3."""
        sub = (lambda i: None) if seed is None else (lambda i: seed + i)
        x = x + self.drop(self.self_attention(self.ln_1(x), seed=sub(0)),
                          sub(1))
        x = x + self.mlp(self.ln_2(x), sub(2))
        return self.peg(x)


class _CPVTBase(nn.Module, TrainableModel):
    """The shared trunk, with the JAX package's constructor arguments plus
    ``device`` (default CUDA; raises without one unless ``device="cpu"``) and
    ``seed`` for the initial weights. ``config`` holds the kwargs that
    rebuild it."""

    def __init__(self, image_size: int, patch_size: int, num_layers: int,
                 num_heads: int, hidden_dim: int, mlp_dim: int,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 num_classes: int = 1000, dtype: DtypeLike = torch.float32,
                 in_channels: int = 3, *, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("Input shape indivisible by patch size!")
        device = resolve_device(device)
        dtype = as_dtype(dtype)
        self.config: Dict[str, Any] = dict(
            image_size=image_size, patch_size=patch_size,
            num_layers=num_layers, num_heads=num_heads,
            hidden_dim=hidden_dim, mlp_dim=mlp_dim, dropout=dropout,
            attention_dropout=attention_dropout, num_classes=num_classes,
            dtype=dtype_name(dtype), in_channels=in_channels)
        self.hidden_dim, self.num_layers = hidden_dim, num_layers
        self.has_dropout = dropout > 0.0 or attention_dropout > 0.0
        gen = torch.Generator().manual_seed(seed)
        self.dropout_generator = torch.Generator().manual_seed(seed)
        self.conv_proj = PatchEmbed(hidden_dim, patch_size, in_channels,
                                    dtype=dtype, generator=gen)
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.pos_embedding = ConditionalPositionalEncoding(
            hidden_dim, dtype=dtype, generator=gen)
        self.input_dropout = Dropout(dropout)
        for i in range(num_layers):
            self.add_module(f"encoder_layer_{i}", PEGEncoderBlock(
                num_heads, hidden_dim, mlp_dim, dropout, attention_dropout,
                dtype=dtype, generator=gen))
        self.ln = LayerNorm(hidden_dim, eps=1e-6, dtype=dtype)
        self.head = Dense(hidden_dim, num_classes, dtype=dtype,
                          weight_init=zeros_, bias_init=zeros_)
        self.to(device)
        self.eval()  # the JAX package's default is deterministic=True

    def forward_features(self, images: torch.Tensor) -> torch.Tensor:
        tokens, _ = self.conv_proj(images)
        cls = self.class_token.to(tokens.dtype).expand(
            tokens.shape[0], 1, self.hidden_dim)
        tokens = self.pos_embedding(torch.cat([cls, tokens], dim=1))
        seeds = draw_block_seeds(self, self.num_layers + 1)
        tokens = self.input_dropout(tokens, seeds[-1])
        for i in range(self.num_layers):
            tokens = getattr(self, f"encoder_layer_{i}")(tokens, seeds[i])
        return self.ln(tokens)


class CPVT(_CPVTBase):
    """Class-token head."""

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.head(self.forward_features(images)[:, 0])


class CPVTGAP(_CPVTBase):
    """Global-average-pool head over the patch tokens."""

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.head(self.forward_features(images)[:, 1:].mean(dim=1))
