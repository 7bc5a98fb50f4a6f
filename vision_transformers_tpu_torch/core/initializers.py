"""Weight initializers: the distributions of
``vision_transformers_tpu/core/initializers.py``, drawn with a
``torch.Generator``.

Each function fills a tensor in place and returns it. The numbers differ
from JAX's for the same seed (different generators); the distributions are
the same, which is all the models rely on. Parity tests load the same
weights into both packages instead.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# std of a unit normal truncated to [-2, 2]; jax's truncated_normal divides
# by it so that the truncated draw has exactly the requested stddev
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float = 0.02,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """N(0, std) truncated at ±2 standard deviations (jax semantics: the
    truncated distribution has stddev ``std``). Inverse-CDF sampling."""
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, \
        (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = torch.empty(t.shape, dtype=torch.float64).uniform_(
        lo, hi, generator=generator)
    x = torch.special.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    return t.copy_(x.clamp_(-2.0, 2.0) * (std / _TRUNC_STD))


@torch.no_grad()
def xavier_uniform_(t: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """U(±sqrt(6 / (fan_in + fan_out))) for a torch (out, in) weight — the
    same fans as flax's (in, out) kernel."""
    fan_out, fan_in = t.shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def normal_(t: torch.Tensor, std: float = 0.02,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return t.normal_(0.0, std, generator=generator)


@torch.no_grad()
def tiny_normal_(t: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Bias init ~ N(0, 1e-6) used by the reference MLP blocks."""
    return t.normal_(0.0, 1e-6, generator=generator)


@torch.no_grad()
def zeros_(t: torch.Tensor,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return t.zero_()


@torch.no_grad()
def conv_patch_(t: torch.Tensor, patch_size: int, in_channels: int = 3,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """trunc_normal(std=sqrt(1/fan_in)) for the patch projection,
    fan_in = in_channels · patch_size²."""
    fan_in = in_channels * patch_size * patch_size
    return trunc_normal_(t, math.sqrt(1.0 / fan_in), generator)
