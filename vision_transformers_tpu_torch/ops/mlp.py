"""Transformer MLP block.

Counterpart of ``vision_transformers_tpu/ops/mlp.py::MLPBlock``: Linear →
GELU → Dropout → Linear → Dropout with xavier-uniform weights and
N(0, 1e-6) biases (the reference encoder MLP). Plain matrix products: the
JAX package leaves them to XLA, and this port to ``torch.matmul``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vision_transformers_tpu_torch.core.initializers import tiny_normal_
from vision_transformers_tpu_torch.ops.layers import Dense, Dropout


def gelu_for(dtype: torch.dtype) -> Callable[[torch.Tensor], torch.Tensor]:
    """Exact (erf) GELU in fp32; tanh-approximate in bf16, as the JAX
    package does (its approximation error is below bf16 rounding)."""
    approximate = "tanh" if dtype == torch.bfloat16 else "none"
    return lambda x: F.gelu(x, approximate=approximate)


class MLPBlock(nn.Module):
    """Reference ViT encoder MLP: in → mlp_dim → out (default: in)."""

    def __init__(self, in_dim: int, mlp_dim: int,
                 out_dim: Optional[int] = None, dropout: float = 0.0, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out_dim = in_dim if out_dim is None else out_dim
        self.fc1 = Dense(in_dim, mlp_dim, dtype=dtype, bias_init=tiny_normal_,
                         generator=generator)
        self.fc2 = Dense(mlp_dim, out_dim, dtype=dtype, bias_init=tiny_normal_,
                         generator=generator)
        self.act = gelu_for(dtype)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor, seed: Optional[int] = None
                ) -> torch.Tensor:
        """``seed`` (training with dropout > 0): the two masks are made from
        seed and seed + 1."""
        x = self.drop(self.act(self.fc1(x)), seed)
        return self.drop(self.fc2(x), None if seed is None else seed + 1)
