"""Positional encodings.

Counterpart of ``vision_transformers_tpu/ops/posenc.py``.

``ConditionalPositionalEncoding``: the CPVT/CPE-ViT PEG — a depthwise k×k
conv over the 2D token grid with the class token passing through untouched.
Token maps are NHWC at the boundary; the conv is ``F.conv2d(groups=C)``, as
Twins' ``PosCNN`` does. ``proj.weight`` is torch's (C, 1, k, k): flax's
(k, k, 1, C) kernel transposed.

``sincos_pos_embed_2d``: fixed 2D sin-cos embedding (the DETR ViT backbone's
position encoding), numpy, the JAX module's arithmetic.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vision_transformers_tpu_torch.core.dtypes import PARAM_DTYPE
from vision_transformers_tpu_torch.core.initializers import trunc_normal_


class ConditionalPositionalEncoding(nn.Module):
    """Depthwise-conv PEG on (B, S, D) token sequences.

    If ``with_cls`` the first token is the class token and bypasses the
    conv; the remaining tokens form the ``grid`` (a square one when
    ``grid`` is omitted). The conv has a bias and "SAME" padding, and is
    initialised as flax's ``nn.Conv`` default (LeCun normal over a fan-in of
    k², zero bias); the module is named ``conv`` as in the JAX tree."""

    def __init__(self, dim: int, kernel_size: int = 3, with_cls: bool = True,
                 *, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if kernel_size % 2 == 0:
            raise ValueError("kernel_size must be odd ('SAME' padding)")
        self.kernel_size = kernel_size
        self.with_cls = with_cls
        self.dtype = dtype
        conv = nn.Module()
        conv.weight = nn.Parameter(trunc_normal_(
            torch.empty(dim, 1, kernel_size, kernel_size, dtype=PARAM_DTYPE),
            (1.0 / kernel_size ** 2) ** 0.5, generator))
        conv.bias = nn.Parameter(torch.zeros(dim, dtype=PARAM_DTYPE))
        self.conv = conv

    def forward(self, tokens: torch.Tensor,
                grid: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        b, s, d = tokens.shape
        if self.with_cls:
            cls, x = tokens[:, :1], tokens[:, 1:]
            n = s - 1
        else:
            cls, x = None, tokens
            n = s
        if grid is None:
            side = math.isqrt(n)
            if side * side != n:
                raise ValueError(
                    "Sequence length must be a perfect square"
                    + (" minus one for the class token" if self.with_cls
                       else ""))
            grid = (side, side)
        h, w = grid
        dt = self.dtype
        g = x.to(dt).reshape(b, h, w, d).permute(0, 3, 1, 2)
        y = F.conv2d(g, self.conv.weight.to(dt), self.conv.bias.to(dt),
                     padding=self.kernel_size // 2, groups=d)
        y = y.permute(0, 2, 3, 1).reshape(b, n, d)
        if cls is not None:
            y = torch.cat([cls.to(y.dtype), y], dim=1)
        return y


def sincos_pos_embed_2d(embed_dim: int, grid_h: int, grid_w: int) -> np.ndarray:
    """Fixed 2D sine-cosine positional embedding, (grid_h*grid_w, embed_dim)."""
    if embed_dim % 4:
        raise ValueError(f"embed_dim {embed_dim} must be a multiple of 4")

    def _1d(dim, positions):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("p,d->pd", positions, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gy, gx = np.meshgrid(
        np.arange(grid_h, dtype=np.float64),
        np.arange(grid_w, dtype=np.float64),
        indexing="ij",
    )
    emb_h = _1d(embed_dim // 2, gy.reshape(-1))
    emb_w = _1d(embed_dim // 2, gx.reshape(-1))
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)
