"""Transformer MLP blocks.

Counterpart of ``vision_transformers_tpu/ops/mlp.py``. ``MLPBlock``: Linear →
GELU → Dropout → Linear → Dropout with xavier-uniform weights and
N(0, 1e-6) biases (the reference encoder MLP, also Swin's). ``Mlp``: the
timm-style two-layer MLP of the PVT and Twins families, trunc-normal 0.02
weights and zero biases. Plain matrix products: the JAX package leaves them
to XLA, and this port to ``torch.matmul``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vision_transformers_tpu_torch.core.initializers import (
    tiny_normal_,
    trunc_normal_,
    zeros_,
)
from vision_transformers_tpu_torch.ops.layers import Dense, Dropout
from vision_transformers_tpu_torch.ops.quant import QuantDense
from vision_transformers_tpu_torch.parallel.mesh import (
    ColumnParallelDense,
    RowParallelDense,
)


class _TwoLayer(nn.Module):
    """What the two MLPs share: ``fc1`` → act → dropout → ``fc2`` →
    dropout, and tensor parallelism (``parallel.shard_params``): ``fc1``
    column-parallel, ``fc2`` row-parallel, the first mask over this rank's
    hidden units drawn from its own seed."""

    tp = None

    def tp_divides(self, size: int) -> bool:
        return (isinstance(self.fc1, Dense)
                and self.fc1.weight.shape[0] % size == 0)

    def tp_shard(self, tp) -> None:
        self.fc1 = ColumnParallelDense(self.fc1, tp)
        self.fc2 = RowParallelDense(self.fc2, tp)
        self.tp = tp

    def forward(self, x: torch.Tensor, seed: Optional[int] = None
                ) -> torch.Tensor:
        """``seed`` (training with dropout > 0): the two masks are made from
        seed and seed + 1."""
        hidden_seed = seed if self.tp is None else self.tp.seed(seed)
        x = self.drop(self.act(self.fc1(x)), hidden_seed)
        return self.drop(self.fc2(x), None if seed is None else seed + 1)


def gelu_for(dtype: torch.dtype) -> Callable[[torch.Tensor], torch.Tensor]:
    """Exact (erf) GELU in fp32; tanh-approximate in bf16, as the JAX
    package does (its approximation error is below bf16 rounding)."""
    approximate = "tanh" if dtype == torch.bfloat16 else "none"
    return lambda x: F.gelu(x, approximate=approximate)


class MLPBlock(_TwoLayer):
    """Reference ViT encoder MLP: in → mlp_dim → out (default: in).
    ``quant8`` (serving): ``fc1`` and ``fc2`` are ``QuantDense`` (w8a8)."""

    def __init__(self, in_dim: int, mlp_dim: int,
                 out_dim: Optional[int] = None, dropout: float = 0.0, *,
                 dtype: torch.dtype = torch.float32, quant8: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out_dim = in_dim if out_dim is None else out_dim
        if quant8:
            self.fc1 = QuantDense(in_dim, mlp_dim, dtype=dtype)
            self.fc2 = QuantDense(mlp_dim, out_dim, dtype=dtype)
        else:
            self.fc1 = Dense(in_dim, mlp_dim, dtype=dtype,
                             bias_init=tiny_normal_, generator=generator)
            self.fc2 = Dense(mlp_dim, out_dim, dtype=dtype,
                             bias_init=tiny_normal_, generator=generator)
        self.act = gelu_for(dtype)
        self.drop = Dropout(dropout)


class Mlp(_TwoLayer):
    """timm-style MLP: in → hidden (default: in) → out (default: in), with
    the dtype-appropriate GELU unless ``act`` is given and dropout after both
    layers. ``forward(x, seed)`` as ``MLPBlock``."""

    def __init__(self, in_dim: int, hidden_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, dropout: float = 0.0,
                 act: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 *, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        init = dict(dtype=dtype, weight_init=trunc_normal_, bias_init=zeros_,
                    generator=generator)
        self.fc1 = Dense(in_dim, hidden_dim or in_dim, **init)
        self.fc2 = Dense(hidden_dim or in_dim, out_dim or in_dim, **init)
        self.act = act or gelu_for(dtype)
        self.drop = Dropout(dropout)
