"""DETR backbone: ResNet-50 with frozen-BN semantics and multi-scale taps.

Counterpart of ``vision_transformers_tpu/models/object_detection/
backbone.py``:

- ``FrozenBatchNorm``: affine transform with frozen statistics and affine
  parameters. Its four leaves (``weight``, ``bias``, ``mean``, ``var``)
  are parameters that take no gradient (the forward reads them detached,
  as the JAX module reads them through ``stop_gradient``) and that an
  optimizer still holds: the DETR recipe's AdamW decays them every step, as
  ``optax.adamw`` decays every leaf of the JAX params tree.
- ``_norm``: ``frozen_bn`` or ``group`` (32 groups, fp32 statistics).
- ``ResNet``: ResNet-50 layout with ``stage_sizes``, NHWC maps at the
  boundaries, ``replace_stride_with_dilation`` with torchvision's rule (a
  dilated stage's first block keeps the dilation before the doubling), and
  ``return_interm_layers`` → {'0': C2, '1': C3, '2': C4, '3': C5}.
- ``ViTBackbone``: patch embedding, fixed sin-cos positions and the port's
  ViT ``EncoderBlock``s; one level {'0': (B, H/p, W/p, D)}. At COCO size
  its attention is the streaming kernel (S = 4704 at 896 × 1344).

Convolutions are ``F.conv2d`` (cuDNN on the card), as the JAX package
leaves them to XLA: ``Conv`` takes NHWC maps and hands cuDNN a
``channels_last`` view of them, no copy. Weights are torch's
(out, in/groups, kh, kw): flax's (kh, kw, in, out) kernel transposed.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vision_transformers_tpu_torch.core.dtypes import PARAM_DTYPE
from vision_transformers_tpu_torch.core.initializers import trunc_normal_
from vision_transformers_tpu_torch.models.image_classification.vanilla_vit import (
    EncoderBlock,
)
from vision_transformers_tpu_torch.ops.layers import LayerNorm
from vision_transformers_tpu_torch.ops.patch_embed import PatchEmbed
from vision_transformers_tpu_torch.ops.posenc import sincos_pos_embed_2d

_Pair = Tuple[int, int]


def _pair(x) -> _Pair:
    return (x, x) if isinstance(x, int) else tuple(x)


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC maps, computing in ``dtype``: explicit
    (symmetric) padding, stride, dilation, groups, optional bias.
    Initialised as flax's default (LeCun normal over the fan-in, zero
    bias)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 bias: bool = True, *, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride, self.padding = _pair(stride), _pair(padding)
        self.dilation, self.groups = _pair(dilation), groups
        self.dtype = dtype
        fan_in = in_channels // groups * kh * kw
        self.weight = nn.Parameter(trunc_normal_(
            torch.empty(out_channels, in_channels // groups, kh, kw,
                        dtype=PARAM_DTYPE), math.sqrt(1.0 / fan_in),
            generator))
        self.bias = (nn.Parameter(torch.zeros(out_channels, dtype=PARAM_DTYPE))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt),
                     None if self.bias is None else self.bias.to(dt),
                     self.stride, self.padding, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with all statistics and affine parameters frozen."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features, dtype=PARAM_DTYPE))
        self.bias = nn.Parameter(torch.zeros(features, dtype=PARAM_DTYPE))
        self.mean = nn.Parameter(torch.zeros(features, dtype=PARAM_DTYPE))
        self.var = nn.Parameter(torch.ones(features, dtype=PARAM_DTYPE))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, bias, mean, var = (p.detach() for p in (
            self.weight, self.bias, self.mean, self.var))
        inv = scale * torch.rsqrt(var + self.epsilon)
        # fold to per-channel (inv, shift) in fp32, apply in x's dtype
        return x * inv.to(x.dtype) + (bias - mean * inv).to(x.dtype)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=32)`` on NHWC maps: fp32 statistics,
    eps 1e-6, output in ``dtype``."""

    def __init__(self, features: int, num_groups: int = 32,
                 epsilon: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_groups, self.epsilon, self.dtype = num_groups, epsilon, dtype
        self.weight = nn.Parameter(torch.ones(features, dtype=PARAM_DTYPE))
        self.bias = nn.Parameter(torch.zeros(features, dtype=PARAM_DTYPE))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.num_groups,
                         self.weight, self.bias, self.epsilon)
        return y.permute(0, 2, 3, 1).to(self.dtype)


def _norm(kind: str, features: int, dtype: torch.dtype) -> nn.Module:
    if kind == "frozen_bn":
        return FrozenBatchNorm(features)
    if kind == "group":
        return GroupNorm(features, dtype=dtype)
    raise ValueError(f"norm {kind!r}: 'frozen_bn' or 'group'")


class Bottleneck(nn.Module):
    """ResNet bottleneck 1x1 → 3x3 → 1x1 (expansion 4), the stride on the
    3x3 and on the projection shortcut."""

    def __init__(self, in_channels: int, features: int, strides: int = 1,
                 dilation: int = 1, norm: str = "frozen_bn",
                 downsample: bool = False, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, generator=generator)
        self.conv1 = Conv(in_channels, features, 1, **kw)
        self.bn1 = _norm(norm, features, dtype)
        self.conv2 = Conv(features, features, 3, stride=strides,
                          padding=dilation, dilation=dilation, **kw)
        self.bn2 = _norm(norm, features, dtype)
        self.conv3 = Conv(features, features * 4, 1, **kw)
        self.bn3 = _norm(norm, features * 4, dtype)
        if downsample:
            self.down_conv = Conv(in_channels, features * 4, 1,
                                  stride=strides, **kw)
            self.down_bn = _norm(norm, features * 4, dtype)
        else:
            self.down_conv = self.down_bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.down_conv is not None:
            residual = self.down_bn(self.down_conv(x))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet-50-style backbone (layers [3, 4, 6, 3]) with NHWC maps.
    Blocks are registered as ``layer{stage}_block{i}`` (the JAX names)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 norm: str = "frozen_bn",
                 replace_stride_with_dilation: Sequence[bool] = (
                     False, False, True),
                 return_interm_layers: bool = True, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.return_interm_layers = return_interm_layers
        kw = dict(dtype=dtype, generator=generator)
        self.conv1 = Conv(3, 64, 7, stride=2, padding=3, bias=False, **kw)
        self.bn1 = _norm(norm, 64, dtype)
        self.stages = []
        channels, dilation = 64, 1
        for stage, blocks in enumerate(stage_sizes):
            features = 64 * 2 ** stage
            stride = 1 if stage == 0 else 2
            prev_dilation = dilation
            if stage > 0 and replace_stride_with_dilation[stage - 1]:
                dilation *= stride
                stride = 1
            names = []
            for i in range(blocks):
                # torchvision semantics: a dilated stage's FIRST block keeps
                # the pre-doubling dilation; only later blocks use the new one
                name = f"layer{stage + 1}_block{i}"
                self.add_module(name, Bottleneck(
                    channels, features, strides=stride if i == 0 else 1,
                    dilation=prev_dilation if i == 0 else dilation, norm=norm,
                    downsample=i == 0, **kw))
                channels = features * 4
                names.append(name)
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        outs = {}
        for stage, names in enumerate(self.stages):
            for name in names:
                y = getattr(self, name)(y)
            outs[str(stage)] = y
        if self.return_interm_layers:
            return outs
        return {"0": outs[str(len(self.stages) - 1)]}


class ViTBackbone(nn.Module):
    """ViT feature extractor for detection: patch embed + encoder blocks, no
    CLS token, fixed 2D sin-cos positions; returns the final token grid as a
    single level {'0': (B, H/p, W/p, D)}. Images are zero-padded at the
    bottom and right to a multiple of the patch."""

    def __init__(self, hidden_dim: int = 768, patch_size: int = 16,
                 num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_dim, self.patch_size = hidden_dim, patch_size
        self.num_layers = num_layers
        self.patch_embed = PatchEmbed(hidden_dim, patch_size, dtype=dtype,
                                      generator=generator)
        for i in range(num_layers):
            self.add_module(f"block{i}", EncoderBlock(
                num_heads, hidden_dim, mlp_dim, dtype=dtype,
                generator=generator))
        self.norm = LayerNorm(hidden_dim, eps=1e-6, dtype=dtype)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        b, h, w, _ = images.shape
        p = self.patch_size
        if h % p or w % p:
            images = F.pad(images, (0, 0, 0, (-w) % p, 0, (-h) % p))
        tokens, (gh, gw) = self.patch_embed(images)
        pos = torch.from_numpy(sincos_pos_embed_2d(self.hidden_dim, gh, gw))
        tokens = tokens + pos.to(tokens.device, tokens.dtype)[None]
        for i in range(self.num_layers):
            tokens = getattr(self, f"block{i}")(tokens)
        tokens = self.norm(tokens)
        return {"0": tokens.reshape(b, gh, gw, self.hidden_dim)}


def build_backbone(trainable_backbone: bool = True, *,
                   arch: str = "resnet50", norm: str = "frozen_bn",
                   return_interm_layers: bool = True,
                   dtype: torch.dtype = torch.float32,
                   generator: Optional[torch.Generator] = None,
                   **vit_kwargs) -> Tuple[nn.Module, int]:
    """(model, num_channels). ``arch``: 'resnet50' or 'vit'."""
    if arch == "vit":
        model = ViTBackbone(dtype=dtype, generator=generator, **vit_kwargs)
        return model, model.hidden_dim
    if arch != "resnet50":
        raise ValueError(f"arch {arch!r}: 'resnet50' or 'vit'")
    model = ResNet(norm=norm, return_interm_layers=return_interm_layers,
                   dtype=dtype, generator=generator)
    return model, 2048


def backbone_param_filter(path: str) -> bool:
    """True for parameters the reference keeps trainable when the backbone
    is not trained (layers 2-4 only)."""
    return any(f"layer{i}_" in path for i in (2, 3, 4))
