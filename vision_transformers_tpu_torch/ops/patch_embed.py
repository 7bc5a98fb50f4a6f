"""Patch embeddings.

Counterpart of ``vision_transformers_tpu/ops/patch_embed.py``. A stride-p
p×p conv over non-overlapping patches is a reshape plus a matmul
(``PatchEmbed``). Inputs are NHWC, as in the JAX package, and ``patchify``
orders each patch's features (ph, pw, c), so the same array and the same
``proj`` weights feed both packages. ``OverlapPatchEmbed`` is the strided
conv for overlapping kernels (kernel > stride), ``F.conv2d`` on the NHWC
map, as the JAX package leaves it to XLA's conv.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from vision_transformers_tpu_torch.core.dtypes import PARAM_DTYPE
from vision_transformers_tpu_torch.core.initializers import (
    conv_patch_,
    trunc_normal_,
)
from vision_transformers_tpu_torch.ops.layers import Dense, LayerNorm


def patchify(images: torch.Tensor,
             patch_size: Union[int, Sequence[int]]) -> torch.Tensor:
    """(B, H, W, C) → (B, H/ph · W/pw, ph·pw·C) non-overlapping patches;
    ``patch_size`` is p or (ph, pw)."""
    b, h, w, c = images.shape
    ph, pw = ((patch_size, patch_size) if isinstance(patch_size, int)
              else patch_size)
    if h % ph or w % pw:
        raise ValueError(
            f"image {h}x{w} indivisible by patch size {ph}x{pw}")
    x = images.reshape(b, h // ph, ph, w // pw, pw, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (B, nh, nw, ph, pw, C)
    return x.reshape(b, (h // ph) * (w // pw), ph * pw * c)


class PatchEmbed(nn.Module):
    """Non-overlapping patch embedding (conv as matmul).

    Init mirrors the reference conv patch embed: trunc_normal with
    std=sqrt(1/fan_in), zero bias. ``norm=True`` adds the LayerNorm
    (eps 1e-6) after the projection that PVT and Twins use. Returns
    (tokens, (grid_h, grid_w)).
    """

    def __init__(self, embed_dim: int, patch_size: int, in_channels: int = 3,
                 norm: bool = False, *, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Dense(
            patch_size * patch_size * in_channels, embed_dim, dtype=dtype,
            weight_init=functools.partial(
                conv_patch_, patch_size=patch_size, in_channels=in_channels),
            generator=generator)
        self.norm = LayerNorm(embed_dim, eps=1e-6, dtype=dtype) if norm \
            else None

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, Tuple[int, int]]:
        _, h, w, _ = images.shape
        p = self.patch_size
        tokens = self.proj(patchify(images, p))
        if self.norm is not None:
            tokens = self.norm(tokens)
        return tokens, (h // p, w // p)


class OverlapPatchEmbed(nn.Module):
    """Strided conv patch embedding (flax ``nn.Conv`` with a bias, symmetric
    ``padding``, no norm) → (tokens (B, gh·gw, embed_dim), (gh, gw)). Its
    ``proj.weight`` is torch's (out, in, k, k), flax's (k, k, in, out)
    kernel transposed; initialised as flax's default (LeCun normal over the
    fan-in, zero bias)."""

    def __init__(self, embed_dim: int, kernel_size: int, stride: int,
                 padding: int = 0, in_channels: int = 3, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        proj = nn.Module()
        proj.weight = nn.Parameter(trunc_normal_(
            torch.empty(embed_dim, in_channels, kernel_size, kernel_size,
                        dtype=PARAM_DTYPE),
            math.sqrt(1.0 / (in_channels * kernel_size ** 2)), generator))
        proj.bias = nn.Parameter(torch.zeros(embed_dim, dtype=PARAM_DTYPE))
        self.proj = proj

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, Tuple[int, int]]:
        dt = self.dtype
        y = F.conv2d(images.to(dt).permute(0, 3, 1, 2),
                     self.proj.weight.to(dt), self.proj.bias.to(dt),
                     self.stride, self.padding)
        b, d, gh, gw = y.shape
        return y.permute(0, 2, 3, 1).reshape(b, gh * gw, d), (gh, gw)
