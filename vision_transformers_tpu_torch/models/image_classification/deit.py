"""DeiT: the distilled ViT (class and distillation tokens, two heads).

Counterpart of ``vision_transformers_tpu/models/image_classification/
deit.py``: patch embed as a matmul (inputs whose sides are not a multiple
of the patch are zero-padded up to one), class token + distillation token,
a learned position embedding, pre-LN ``EncoderBlock``s of the ViT (so the
``USE_FUSED_BLOCK`` inference path serves them too), a final LN and two
zero-initialised heads. With ``distilled_training=True`` a training-mode
forward returns (cls_logits, dist_logits); otherwise the mean of the two.
``train_model_with_distillation`` trains against a teacher (DeiT's hard or
soft distillation, ``utils/distillation_loss.py``). Inputs are NHWC.

Module names mirror the JAX params tree (``patch_embed.proj``,
``cls_token``, ``dist_token``, ``pos_embed``, ``block{i}``, ``norm_f``,
``head``, ``head_dist``), so ``utils.port_jax.deit_state_dict_from_jax`` is
a rename and a transpose. Dropout seeds come from ``dropout_generator`` as
in the ViT.
"""

from __future__ import annotations

from typing import Any, Dict

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
from vision_transformers_tpu_torch.models.image_classification.vanilla_vit import (
    EncoderBlock,
)
from vision_transformers_tpu_torch.ops.layers import Dense, Dropout, LayerNorm
from vision_transformers_tpu_torch.ops.patch_embed import PatchEmbed


class DeiT(nn.Module, TrainableModel):
    """DeiT classifier with the JAX package's constructor arguments, plus
    ``device`` (default CUDA; raises without one unless ``device="cpu"``)
    and ``seed`` for the initial weights. ``config`` holds the kwargs that
    rebuild it."""

    def __init__(self, image_size: int, patch_size: int, num_layers: int,
                 num_heads: int, embed_dim: int, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 num_classes: int = 100, distilled_training: bool = False,
                 dtype: DtypeLike = torch.float32, in_channels: int = 3, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        dtype = as_dtype(dtype)
        self.config: Dict[str, Any] = dict(
            image_size=image_size, patch_size=patch_size,
            num_layers=num_layers, num_heads=num_heads, embed_dim=embed_dim,
            mlp_ratio=mlp_ratio, dropout=dropout,
            attention_dropout=attention_dropout, num_classes=num_classes,
            distilled_training=distilled_training, dtype=dtype_name(dtype),
            in_channels=in_channels)
        self.patch_size, self.embed_dim = patch_size, embed_dim
        self.num_layers = num_layers
        self.distilled_training = distilled_training
        self.has_dropout = dropout > 0.0 or attention_dropout > 0.0
        gen = torch.Generator().manual_seed(seed)
        self.dropout_generator = torch.Generator().manual_seed(seed)
        grid = -(-image_size // patch_size)
        self.patch_embed = PatchEmbed(embed_dim, patch_size, in_channels,
                                      dtype=dtype, generator=gen)
        self.cls_token = nn.Parameter(trunc_normal_(
            torch.empty(1, 1, embed_dim), 0.02, gen))
        self.dist_token = nn.Parameter(trunc_normal_(
            torch.empty(1, 1, embed_dim), 0.02, gen))
        self.pos_embed = nn.Parameter(trunc_normal_(
            torch.empty(1, grid * grid + 2, embed_dim), 0.02, gen))
        self.pos_drop = Dropout(dropout)
        for i in range(num_layers):
            self.add_module(f"block{i}", EncoderBlock(
                num_heads, embed_dim, int(embed_dim * mlp_ratio), dropout,
                attention_dropout, dtype=dtype, generator=gen))
        self.norm_f = LayerNorm(embed_dim, eps=1e-6, dtype=dtype)
        self.head = Dense(embed_dim, num_classes, dtype=dtype,
                          weight_init=zeros_, bias_init=zeros_)
        self.head_dist = Dense(embed_dim, num_classes, dtype=dtype,
                               weight_init=zeros_, bias_init=zeros_)
        self.to(device)
        self.eval()  # the JAX package's default is deterministic=True

    def forward_features(self, images: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = images.shape
        p = self.patch_size
        if h % p or w % p:  # pad up to the next patch multiple
            images = F.pad(images, (0, 0, 0, (-w) % p, 0, (-h) % p))
        tokens, _ = self.patch_embed(images)
        cls = self.cls_token.to(tokens.dtype).expand(n, 1, self.embed_dim)
        dist = self.dist_token.to(tokens.dtype).expand(n, 1, self.embed_dim)
        tokens = torch.cat([cls, dist, tokens], dim=1)
        seeds = draw_block_seeds(self, self.num_layers + 1)
        tokens = self.pos_drop(tokens + self.pos_embed.to(tokens.dtype),
                               seeds[-1])
        for i in range(self.num_layers):
            tokens = getattr(self, f"block{i}")(tokens, False, seeds[i])
        return self.norm_f(tokens)

    def forward(self, images: torch.Tensor):
        feats = self.forward_features(images)
        cls_logits = self.head(feats[:, 0])
        dist_logits = self.head_dist(feats[:, 1])
        if self.distilled_training and self.training:
            return cls_logits, dist_logits
        return (cls_logits + dist_logits) / 2.0

    def train_model_with_distillation(self, train_loader, test_loader,
                                      epochs: int, val_loader=None, *,
                                      teacher=None,
                                      distillation_type: str = "hard",
                                      alpha: float = 0.5, tau: float = 5.0,
                                      **fit_kwargs):
        """The reference's distillation surface (deit.py:36-137) over the
        shared trainer, so it inherits ``steps_per_call`` and checkpointing
        from ``fit``. ``teacher``: a callable images → logits (a module is
        put in eval mode), or (module, state_dict); there is no pretrained
        teacher to fall back on. The model trains with
        ``distilled_training`` on (its training forward returns both
        heads' logits) and gets its own setting back afterwards. Extra
        kwargs (lr, seed, verbose, mesh, steps_per_call, checkpoint_*) go
        to ``fit``; under a ``mesh`` the teacher runs on each rank's slice
        of the batch too."""
        from vision_transformers_tpu_torch.training.trainer import fit

        if teacher is None:
            raise ValueError(
                "DeiT distillation needs an injected teacher: pass "
                "teacher=(module, state_dict) or a callable images->logits")
        if isinstance(teacher, tuple):
            t_model, t_weights = teacher
            t_model.load_state_dict(t_weights)
            teacher = t_model
        if isinstance(teacher, nn.Module):
            teacher.eval()
        prev = self.distilled_training
        self.distilled_training = True
        try:
            return fit(self, train_loader, test_loader, epochs, val_loader,
                       teacher_fn=teacher,
                       distill=(distillation_type, alpha, tau), **fit_kwargs)
        finally:
            self.distilled_training = prev
