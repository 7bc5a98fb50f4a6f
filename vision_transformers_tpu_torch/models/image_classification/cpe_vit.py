"""CPE-ViT: the ViT plus one Conditional Positional Encoding.

Counterpart of ``vision_transformers_tpu/models/image_classification/
cpe_vit.py``: patch embed, class token, the depthwise-conv CPE
(``ops/posenc.py``) applied once after the class token is attached, then
the ViT ``Encoder`` unchanged (its learned position embedding added on top,
its blocks on the ``USE_FUSED_BLOCK`` path in eval mode), and a
zero-initialised CLS head. Inputs are NHWC.

Module names mirror the JAX params tree (``conv_proj.proj``,
``class_token``, ``pos_embedding.conv``, ``encoder.encoder_layer_{i}``,
``head``), so ``utils.port_jax.cpevit_state_dict_from_jax`` is a rename and
a transpose.
"""

from __future__ import annotations

from typing import Any, Dict

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
)
from vision_transformers_tpu_torch.models.image_classification.vanilla_vit import (
    Encoder,
)
from vision_transformers_tpu_torch.ops.layers import Dense
from vision_transformers_tpu_torch.ops.patch_embed import PatchEmbed
from vision_transformers_tpu_torch.ops.posenc import (
    ConditionalPositionalEncoding,
)


class CPEViT(nn.Module, TrainableModel):
    """CPE-ViT classifier with the JAX package's constructor arguments, plus
    ``device`` (default CUDA; raises without one unless ``device="cpu"``)
    and ``seed`` for the initial weights. ``config`` holds the kwargs that
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
        self.hidden_dim = hidden_dim
        gen = torch.Generator().manual_seed(seed)
        self.dropout_generator = torch.Generator().manual_seed(seed)
        self.conv_proj = PatchEmbed(hidden_dim, patch_size, in_channels,
                                    dtype=dtype, generator=gen)
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.pos_embedding = ConditionalPositionalEncoding(
            hidden_dim, dtype=dtype, generator=gen)
        self.encoder = Encoder(
            (image_size // patch_size) ** 2 + 1, num_layers, num_heads,
            hidden_dim, mlp_dim, dropout, attention_dropout, dtype=dtype,
            generator=gen, dropout_generator=self.dropout_generator)
        self.head = Dense(hidden_dim, num_classes, dtype=dtype,
                          weight_init=zeros_, bias_init=zeros_)
        self.to(device)
        self.eval()  # the JAX package's default is deterministic=True

    def forward_features(self, images: torch.Tensor) -> torch.Tensor:
        tokens, _ = self.conv_proj(images)
        cls = self.class_token.to(tokens.dtype).expand(
            tokens.shape[0], 1, self.hidden_dim)
        tokens = torch.cat([cls, tokens], dim=1)
        # the CPE, then the encoder's learned position embedding
        return self.encoder(self.pos_embedding(tokens))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.head(self.forward_features(images)[:, 0])
