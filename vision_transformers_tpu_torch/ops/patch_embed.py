"""Patch embedding as one matrix product.

Counterpart of ``vision_transformers_tpu/ops/patch_embed.py``. A stride-p
p×p conv over non-overlapping patches is a reshape plus a matmul. Inputs
are NHWC, as in the JAX package, and ``patchify`` orders each patch's
features (ph, pw, c), so the same array and the same ``proj`` weights feed
both packages.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from vision_transformers_tpu_torch.core.initializers import conv_patch_
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
