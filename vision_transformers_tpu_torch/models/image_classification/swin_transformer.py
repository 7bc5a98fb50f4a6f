"""Swin Transformer and SwinV2.

Counterpart of ``vision_transformers_tpu/models/image_classification/
swin_transformer.py``: patch embedding (the stride-p conv as a matmul) + LN,
four stages of window-attention blocks alternating shift 0 / window // 2,
``PatchMerging`` between stages, per-block stochastic depth on a linear
schedule over the total depth, final LN → global average pool → linear
head. Linear weights are trunc-normal 0.02 with zero bias, block MLPs
xavier with N(0, 1e-6) biases, every LayerNorm has eps 1e-5. Feature maps
are NHWC end to end.

SwinV2 (``SwinTransformerV2``) is the same skeleton with cosine attention
and a continuous position bias (``ShiftedWindowAttentionV2``), post-norm
blocks and ``PatchMergingV2``.

Every stage takes ``window_size`` by default, as the JAX package does: a map
smaller than the window is zero-padded to it and attended over unmasked.
``clip_window=True`` (with ``image_size``) takes the published rule instead
(arXiv:2111.09883's code, timm): each stage's window is min(window, map
side) on each axis, and a shifted block shifts only where the window does
not cover the map (``clip_to_map``). SwinV2-B @256 with window 16 then
attends one unpadded 8 × 8 window in its last stage.

Module names mirror the JAX params tree (``patch_embed``, ``patch_norm``,
``stage{i}_block{j}.{norm1,attn,norm2,mlp}``, ``merge{i}``, ``norm``,
``head``), so ``utils.port_jax.swin_state_dict_from_jax`` is a rename, a
transpose and one reshape (the conv kernel).

Attention runs through the window kernels of ``ops/flash_attention.py``,
forward and backward, so the models train on the card through
``train_model`` / ``training.trainer.fit`` as ViT does.

Dropout and stochastic depth are explicit, as in ViT: the model owns one
host ``torch.Generator`` (``dropout_generator``, which ``fit(seed=...)``
seeds); in training mode one integer per block and forward is drawn from it
on the host, and every mask of the block (the two stochastic-depth masks,
the elementwise dropouts, the split-head attention dropout) is a function
of that integer.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
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
from vision_transformers_tpu_torch.ops.layers import Dense, DropPath, LayerNorm
from vision_transformers_tpu_torch.ops.mlp import MLPBlock
from vision_transformers_tpu_torch.ops.patch_embed import patchify
from vision_transformers_tpu_torch.ops.windows import (
    PatchMerging,
    PatchMergingV2,
    ShiftedWindowAttention,
    ShiftedWindowAttentionV2,
)


def _trunc02(t: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return trunc_normal_(t, 0.02, generator)


def clip_to_map(window_size: Sequence[int], side: Sequence[int]
                ) -> Tuple[List[int], List[int]]:
    """A stage's (window, shift of its shifted blocks) on a map of ``side``
    under the published rule: the window is min(window, side) on each axis,
    and the shift is half the window where the window does not cover the
    map, else 0."""
    window = [min(w, s) for w, s in zip(window_size, side)]
    shift = [0 if s <= w else w // 2 for w, s in zip(window, side)]
    return window, shift


class SwinTransformerBlock(nn.Module):
    """x + SD(attn(LN x)); x + SD(mlp(LN x)) on (B, H, W, C) maps.
    ``forward(x, seed)``: ``seed`` is the block's seed for this forward
    (training with dropout or stochastic depth only); its masks come from
    seed .. seed + 5."""

    attention_cls = ShiftedWindowAttention

    def __init__(self, dim: int, num_heads: int, window_size: Sequence[int],
                 shift_size: Sequence[int], mlp_ratio: float = 4.0,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 stochastic_depth_prob: float = 0.0, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.attn = self.attention_cls(
            dim, window_size, shift_size, num_heads,
            attention_dropout=attention_dropout, dropout=dropout, dtype=dtype,
            generator=generator)
        self.norm2 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio), dropout=dropout,
                            dtype=dtype, generator=generator)
        self.stochastic_depth = DropPath(stochastic_depth_prob)

    def forward(self, x: torch.Tensor, seed: Optional[int] = None
                ) -> torch.Tensor:
        sub = (lambda i: None) if seed is None else (lambda i: seed + i)
        x = x + self.stochastic_depth(self.attn(self.norm1(x), seed), sub(4))
        return x + self.stochastic_depth(self.mlp(self.norm2(x), sub(2)),
                                         sub(5))


class SwinTransformerBlockV2(SwinTransformerBlock):
    """SwinV2 post-norm block: x + SD(LN(attn(x))); x + SD(LN(mlp(x)))."""

    attention_cls = ShiftedWindowAttentionV2

    def forward(self, x: torch.Tensor, seed: Optional[int] = None
                ) -> torch.Tensor:
        sub = (lambda i: None) if seed is None else (lambda i: seed + i)
        x = x + self.stochastic_depth(self.norm1(self.attn(x, seed)), sub(4))
        return x + self.stochastic_depth(self.norm2(self.mlp(x, sub(2))),
                                         sub(5))


class SwinTransformer(nn.Module, TrainableModel):
    """Swin classifier with the JAX package's constructor arguments, plus
    ``device`` (default CUDA; raises without one unless ``device="cpu"``),
    ``seed`` for the initial weights and ``in_channels``. ``dtype`` is the
    compute dtype; parameters are fp32. ``config`` holds the constructor
    kwargs that rebuild the model (serving's manifest stores them).
    ``clip_window``: each stage's window and shift by ``clip_to_map`` on
    its map (needs ``image_size``); only a clipped model's ``config``
    carries the key."""

    def __init__(self, patch_size: Sequence[int], embed_dim: int,
                 depths: Sequence[int], num_heads: Sequence[int],
                 window_size: Sequence[int], mlp_ratio: float = 4.0,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 stochastic_depth_prob: float = 0.1, num_classes: int = 100,
                 image_size: Optional[int] = None, v2: bool = False,
                 dtype: DtypeLike = torch.float32, in_channels: int = 3, *,
                 device: DeviceLike = None, seed: int = 0,
                 clip_window: bool = False):
        super().__init__()
        device = resolve_device(device)
        dtype = as_dtype(dtype)
        patch_size = [int(p) for p in patch_size]
        depths = [int(d) for d in depths]
        num_heads = [int(h) for h in num_heads]
        window_size = [int(w) for w in window_size]
        self.config: Dict[str, Any] = dict(
            patch_size=patch_size, embed_dim=embed_dim, depths=depths,
            num_heads=num_heads, window_size=window_size, mlp_ratio=mlp_ratio,
            dropout=dropout, attention_dropout=attention_dropout,
            stochastic_depth_prob=stochastic_depth_prob,
            num_classes=num_classes, image_size=image_size, v2=v2,
            dtype=dtype_name(dtype), in_channels=in_channels)
        if clip_window:
            if image_size is None:
                raise ValueError("clip_window needs image_size: each "
                                 "stage's window follows its map")
            self.config["clip_window"] = True
            side = [image_size // p for p in patch_size]
        self.patch_size = patch_size
        self.has_dropout = (dropout > 0.0 or attention_dropout > 0.0
                            or stochastic_depth_prob > 0.0)
        gen = torch.Generator().manual_seed(seed)
        self.dropout_generator = torch.Generator().manual_seed(seed)

        ph, pw = patch_size
        self.patch_embed = Dense(ph * pw * in_channels, embed_dim, dtype=dtype,
                                 weight_init=_trunc02, bias_init=zeros_,
                                 generator=gen)
        self.patch_norm = LayerNorm(embed_dim, eps=1e-5, dtype=dtype)

        block_cls = SwinTransformerBlockV2 if v2 else SwinTransformerBlock
        merge_cls = PatchMergingV2 if v2 else PatchMerging
        total_blocks = sum(depths)
        self.block_names: List[str] = []  # blocks and merges, in order
        block_id = 0
        for i_stage, depth in enumerate(depths):
            dim = embed_dim * 2 ** i_stage
            window = window_size
            half = [w // 2 for w in window_size]
            if clip_window:
                window, half = clip_to_map(window_size, side)
                side = [(s + 1) // 2 for s in side]  # merging pads odd maps
            for i_layer in range(depth):
                sd_prob = (stochastic_depth_prob * float(block_id)
                           / max(total_blocks - 1, 1))
                shift = [0] * 2 if i_layer % 2 == 0 else half
                name = f"stage{i_stage}_block{i_layer}"
                self.add_module(name, block_cls(
                    dim, num_heads[i_stage], window, shift,
                    mlp_ratio=mlp_ratio, dropout=dropout,
                    attention_dropout=attention_dropout,
                    stochastic_depth_prob=sd_prob, dtype=dtype,
                    generator=gen))
                self.block_names.append(name)
                block_id += 1
            if i_stage < len(depths) - 1:
                name = f"merge{i_stage}"
                self.add_module(name, merge_cls(dim, dtype=dtype,
                                                generator=gen))
                self.block_names.append(name)

        final_dim = embed_dim * 2 ** (len(depths) - 1)
        self.norm = LayerNorm(final_dim, eps=1e-5, dtype=dtype)
        self.head = Dense(final_dim, num_classes, dtype=dtype,
                          weight_init=_trunc02, bias_init=zeros_,
                          generator=gen)
        self.to(device)
        self.eval()  # the JAX package's default is deterministic=True

    def forward_features(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) images → (B, H', W', C') final normalised map."""
        b, h, w, _ = images.shape
        ph, pw = self.patch_size
        x = self.patch_embed(patchify(images, (ph, pw)))
        x = self.patch_norm(x).reshape(b, h // ph, w // pw, -1)
        seeds = draw_block_seeds(self, len(self.block_names))
        for name, seed in zip(self.block_names, seeds):
            block = getattr(self, name)
            x = block(x) if name.startswith("merge") else block(x, seed)
        return self.norm(x)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.forward_features(images)
        return self.head(x.float().mean(dim=(1, 2)).to(x.dtype))


class SwinTransformerV2(SwinTransformer):
    """SwinV2: ``SwinTransformer`` with ``v2=True`` by default."""

    def __init__(self, *args, v2: bool = True, **kwargs):
        super().__init__(*args, v2=v2, **kwargs)
