"""T2T token performer: FAVOR+ linear attention.

Counterpart of ``vision_transformers_tpu/models/image_classification/
token_performer.py``: positive random features exp(wᵀx − |x|²/2)/√m with a
fixed orthogonal projection ``w`` (orthogonal init × √m), linear attention
by associativity, qp·(kpᵀv)/(qp·Σkp + 1e-8), V as the skip connection
through a projection and dropout, then an MLP (erf GELU) residual. From the
feature map through the normalisation everything is fp32 whatever the
compute dtype, as in the JAX package.

``w`` is a parameter that takes no gradient: the forward reads it detached,
as the JAX module reads it through ``stop_gradient``, and an optimizer still
holds it (as ``FrozenBatchNorm``'s leaves are held). The two dropouts
(``dp1``, ``dp2``, 0.1 by default, as in the JAX package, which the T2T
module does not override) act in training mode whatever the model's
``dropout``; their masks come from the seed the caller passes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vision_transformers_tpu_torch.core.dtypes import PARAM_DTYPE
from vision_transformers_tpu_torch.core.initializers import trunc_normal_, zeros_
from vision_transformers_tpu_torch.ops.layers import Dense, Dropout, LayerNorm


class TokenPerformer(nn.Module):
    """(B, T, dim) → (B, T, in_dim·head_cnt). ``forward(x, seed)``: the two
    dropout masks are made from seed and seed + 1 (training mode)."""

    def __init__(self, dim: int, in_dim: int, head_cnt: int = 1,
                 kernel_ratio: float = 0.5, dp1: float = 0.1,
                 dp2: float = 0.1, *, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        emb = in_dim * head_cnt
        self.m = int(emb * kernel_ratio)
        dense = dict(dtype=dtype, weight_init=trunc_normal_, bias_init=zeros_,
                     generator=generator)
        w = torch.empty(self.m, emb, dtype=PARAM_DTYPE)
        nn.init.orthogonal_(w, generator=generator)
        self.w = nn.Parameter(w * math.sqrt(self.m))
        self.norm1 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.kqv = Dense(dim, 3 * emb, **dense)
        self.proj = Dense(emb, emb, **dense)
        self.drop1 = Dropout(dp1)
        self.norm2 = LayerNorm(emb, eps=1e-6, dtype=dtype)
        self.mlp_fc1 = Dense(emb, emb, **dense)
        self.mlp_fc2 = Dense(emb, emb, **dense)
        self.drop2 = Dropout(dp2)

    def _prm_exp(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        xd = (t * t).sum(dim=-1, keepdim=True) / 2.0
        wtx = torch.matmul(t, self.w.detach().float().t())
        return torch.exp(wtx - xd) / math.sqrt(self.m)

    def forward(self, x: torch.Tensor, seed: Optional[int] = None
                ) -> torch.Tensor:
        k, q, v = self.kqv(self.norm1(x)).chunk(3, dim=-1)
        kp, qp = self._prm_exp(k), self._prm_exp(q)            # (B, T, m)
        denom = torch.matmul(qp, kp.sum(dim=1, keepdim=True).transpose(1, 2))
        kptv = torch.matmul(v.float().transpose(1, 2), kp)     # (B, emb, m)
        attn = torch.matmul(qp, kptv.transpose(1, 2)) / (denom + 1e-8)
        proj = self.drop1(self.proj(attn.to(v.dtype)), seed)
        x = v + proj  # V as the skip connection
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + self.drop2(y, None if seed is None else seed + 1)
