"""Small shared layers: ``Dense`` (flax ``nn.Dense`` semantics), LayerNorm
(eps 1e-6 default like the reference), seeded Dropout and DropPath.

Counterpart of ``vision_transformers_tpu/ops/layers.py``. Parameters are
fp32; ``dtype`` is the compute dtype each call casts its input and
parameters to, as flax's ``dtype`` does. LayerNorm statistics are fp32.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vision_transformers_tpu_torch.core.dtypes import PARAM_DTYPE
from vision_transformers_tpu_torch.core.initializers import (
    xavier_uniform_,
    zeros_,
)

Init = Callable[..., torch.Tensor]  # init_(tensor, generator=None)


class Dense(nn.Module):
    """y = x·Wᵀ + b in ``dtype``. ``weight`` is torch's (out, in): the
    transpose of flax's (in, out) ``kernel``."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, dtype: torch.dtype = torch.float32,
                 weight_init: Init = xavier_uniform_, bias_init: Init = zeros_,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            weight_init(torch.empty(out_features, in_features,
                                    dtype=PARAM_DTYPE), generator=generator))
        self.bias = (nn.Parameter(bias_init(
            torch.empty(out_features, dtype=PARAM_DTYPE), generator=generator))
            if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with fp32 statistics; output in
    ``dtype``. ``weight``/``bias`` are flax's ``scale``/``bias``."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=PARAM_DTYPE))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=PARAM_DTYPE))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.dtype)


class Dropout(nn.Module):
    """Elementwise dropout whose mask is a function of an explicit seed.

    ``forward(x, seed)`` builds a generator on x's device from the host
    integer ``seed``, so the same seed gives the same mask: a recomputed
    forward (``remat``) replays it, and nothing reads the global RNG.
    Identity at eval or at rate 0."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, seed: Optional[int] = None
                ) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        if seed is None:
            raise ValueError("dropout in training mode needs a seed")
        gen = torch.Generator(device=x.device).manual_seed(seed)
        keep = torch.rand(x.shape, generator=gen, device=x.device) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class DropPath(nn.Module):
    """Per-sample stochastic depth: drop the whole residual branch with
    probability ``rate``, rescale survivors by 1/(1-rate). Identity at
    eval."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))
