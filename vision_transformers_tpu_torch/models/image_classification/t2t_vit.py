"""T2T-ViT: Tokens-to-Token ViT.

Counterpart of ``vision_transformers_tpu/models/image_classification/
t2t_vit.py``, the intended T2T path: three soft splits (7×7 stride 4
padding 2, then 3×3 stride 2 padding 1 twice) with a token transformer or
token performer after each of the first two, a linear projection to the
embed dim, then the ViT ``Encoder`` (its blocks on the ``USE_FUSED_BLOCK``
path in eval mode) and a zero-initialised CLS head sized to the T2T token
count (image_size / 16 per side). Inputs are NHWC.

Module names mirror the JAX params tree (``t2t.attention{1,2}``,
``t2t.project``, ``class_token``, ``encoder.encoder_layer_{i}``, ``head``),
so ``utils.port_jax.t2t_state_dict_from_jax`` is a rename and a transpose.
With ``token_type="performer"`` (the default) the performers' own dropout
(0.1, see ``token_performer.py``) acts in training mode even at
``dropout=0``; every mask comes from ``dropout_generator``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

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
from vision_transformers_tpu_torch.models.image_classification.token_performer import (
    TokenPerformer,
)
from vision_transformers_tpu_torch.models.image_classification.token_transformer import (
    TokenTransformer,
)
from vision_transformers_tpu_torch.models.image_classification.vanilla_vit import (
    Encoder,
)
from vision_transformers_tpu_torch.ops.layers import Dense


def soft_split(x: torch.Tensor, kernel: int, stride: int, padding: int
               ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Unfold (B, H, W, C) → (tokens (B, N, C·k·k), out_grid), features in
    (C, kh, kw) order, as ``lax.conv_general_dilated_patches`` orders them
    (not ``patchify``'s (kh, kw, C))."""
    b, h, w, _ = x.shape
    patches = F.unfold(x.permute(0, 3, 1, 2), kernel, padding=padding,
                       stride=stride)
    oh = (h + 2 * padding - kernel) // stride + 1
    ow = (w + 2 * padding - kernel) // stride + 1
    return patches.transpose(1, 2), (oh, ow)


class T2T(nn.Module):
    """Tokens-to-token module: (B, H, W, C) → ((B, N, embed_dim), grid).
    ``forward(images, seeds)``: one seed per token layer (training)."""

    def __init__(self, tokens_type: str, embed_dim: int, token_dim: int,
                 in_channels: int = 3, *, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if tokens_type not in ("performer", "transformer"):
            raise ValueError(f"token_type {tokens_type!r}: 'performer' or "
                             "'transformer'")
        self.token_dim = token_dim

        def attn_layer(dim):
            if tokens_type == "performer":
                return TokenPerformer(dim, token_dim, kernel_ratio=0.5,
                                      dtype=dtype, generator=generator)
            return TokenTransformer(dim, token_dim, num_heads=1, mlp_ratio=1.0,
                                    dtype=dtype, generator=generator)

        self.attention1 = attn_layer(in_channels * 7 * 7)
        self.attention2 = attn_layer(token_dim * 3 * 3)
        self.project = Dense(token_dim * 3 * 3, embed_dim, dtype=dtype,
                             weight_init=trunc_normal_, bias_init=zeros_,
                             generator=generator)

    def forward(self, images: torch.Tensor, seeds=(None, None)
                ) -> Tuple[torch.Tensor, Tuple[int, int]]:
        b = images.shape[0]
        x, grid = soft_split(images, 7, 4, 2)
        x = self.attention1(x, seeds[0])
        x = x.reshape(b, grid[0], grid[1], self.token_dim)
        x, grid = soft_split(x, 3, 2, 1)
        x = self.attention2(x, seeds[1])
        x = x.reshape(b, grid[0], grid[1], self.token_dim)
        x, grid = soft_split(x, 3, 2, 1)
        return self.project(x), grid


class T2T_ViT(nn.Module, TrainableModel):
    """T2T-ViT classifier with the JAX package's constructor arguments
    (``patch_size`` is accepted for parity; the T2T defines the grid), plus
    ``in_channels``, ``device`` (default CUDA; raises without one unless
    ``device="cpu"``) and ``seed`` for the initial weights. ``config`` holds
    the kwargs that rebuild it."""

    def __init__(self, image_size: int, patch_size: int, num_layers: int,
                 num_heads: int, hidden_dim: int, mlp_dim: int,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 num_classes: int = 1000, token_dim: int = 64,
                 token_type: str = "performer",
                 dtype: DtypeLike = torch.float32, in_channels: int = 3, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        dtype = as_dtype(dtype)
        self.config: Dict[str, Any] = dict(
            image_size=image_size, patch_size=patch_size,
            num_layers=num_layers, num_heads=num_heads,
            hidden_dim=hidden_dim, mlp_dim=mlp_dim, dropout=dropout,
            attention_dropout=attention_dropout, num_classes=num_classes,
            token_dim=token_dim, token_type=token_type,
            dtype=dtype_name(dtype), in_channels=in_channels)
        self.hidden_dim = hidden_dim
        # the performers drop at 0.1 in training whatever ``dropout`` is
        self.has_dropout = (token_type == "performer" or dropout > 0.0
                            or attention_dropout > 0.0)
        gen = torch.Generator().manual_seed(seed)
        self.dropout_generator = torch.Generator().manual_seed(seed)
        side = image_size // 16  # three soft splits: strides 4, 2, 2
        self.t2t = T2T(token_type, hidden_dim, token_dim, in_channels,
                       dtype=dtype, generator=gen)
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.encoder = Encoder(
            side * side + 1, num_layers, num_heads, hidden_dim, mlp_dim,
            dropout, attention_dropout, dtype=dtype, generator=gen,
            dropout_generator=self.dropout_generator)
        self.head = Dense(hidden_dim, num_classes, dtype=dtype,
                          weight_init=zeros_, bias_init=zeros_)
        self.to(device)
        self.eval()  # the JAX package's default is deterministic=True

    def forward_features(self, images: torch.Tensor) -> torch.Tensor:
        tokens, _ = self.t2t(images, draw_block_seeds(self, 2))
        cls = self.class_token.to(tokens.dtype).expand(
            tokens.shape[0], 1, self.hidden_dim)
        return self.encoder(torch.cat([cls, tokens], dim=1))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.head(self.forward_features(images)[:, 0])
