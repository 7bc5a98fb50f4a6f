"""Multi-head attention: plain oracle, kernel dispatch and the module.

Counterpart of ``vision_transformers_tpu/ops/attention.py``, with the same
routing: ``SelfAttention`` sends its packed QKV projection to the packed
kernel when ``packed_flash_supported`` allows it, and to the split-head
dispatcher otherwise, with the dropout rate and a seed in training. On CUDA
tensors ``dot_product_attention`` takes a kernel wherever the JAX dispatcher
takes a Pallas kernel on the TPU, and the plain math where the JAX package
takes jnp on the TPU too (an arbitrary boolean mask, a bias with dropout, or
a bias at Sq·Sk > 1.5 M).

Dropout randomness is explicit: a host ``torch.Generator`` from which one
integer seed per attention call is drawn (no device synchronisation); the
kernels make their masks from that seed.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vision_transformers_tpu_torch.ops.flash_attention import (
    DEFAULT_MASK_VALUE,
    MAX_SCORE_ELEMS,
    flash_attention,
    flash_dropout_attention,
    packed_flash_attention,
    packed_flash_supported,
)
from vision_transformers_tpu_torch.ops.layers import Dense
from vision_transformers_tpu_torch.ops.quant import QuantDense
from vision_transformers_tpu_torch.parallel.mesh import (
    ColumnParallelDense,
    RowParallelDense,
)


def draw_seed(generator: torch.Generator) -> int:
    """One 62-bit seed for a kernel's dropout mask, drawn on the host."""
    return int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None, *,
                  scale: Optional[float] = None, dropout_rate: float = 0.0,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Plain scaled dot-product attention (the unit-test oracle).

    q, k, v: (B, H, S, D). bias: additive, broadcastable to (B, H, Sq, Sk).
    mask: bool, True = attend, broadcastable to (B, H, Sq, Sk).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        # drawn where the generator lives (the host), then moved
        keep = torch.rand(
            p.shape, generator=generator,
            device=p.device if generator is None else generator.device
        ).to(p.device) >= dropout_rate
        p = torch.where(keep, p / (1.0 - dropout_rate), torch.zeros_like(p))
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          mask: Optional[torch.Tensor] = None, *,
                          scale: Optional[float] = None,
                          kv_valid: Optional[int] = None,
                          dropout_rate: float = 0.0,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """Dispatcher: the split-head kernels for CUDA tensors, their plain
    versions for CPU tensors (the wrappers decide by device).

    ``mask`` (arbitrary boolean) takes the plain math, as in the JAX
    dispatcher. Training-mode probability dropout without a bias, with an
    optional key-padding mask (B, 1, 1, Sk), rides
    ``flash_dropout_attention``; its seed is drawn from ``generator``, a
    host generator. A key-padding mask at rate 0 rides ``flash_attention``
    as its ``kv_mask`` (the streaming kernel).
    """
    # above MAX_SCORE_ELEMS the JAX kernel takes no bias: biased large-S
    # attention takes the plain math there, and here
    small = q.shape[2] * k.shape[2] <= MAX_SCORE_ELEMS
    if mask is None and dropout_rate == 0.0 and (small or bias is None):
        return flash_attention(q, k, v, bias, scale=scale, kv_valid=kv_valid)
    is_key_padding = (
        mask is not None and mask.ndim == 4
        and mask.shape[1] == 1 and mask.shape[2] == 1
        and mask.shape[0] == q.shape[0]
    )
    if (bias is None and dropout_rate > 0.0 and generator is not None
            and (mask is None or is_key_padding)):
        return flash_dropout_attention(
            q, k, v, dropout_rate=dropout_rate, seed=draw_seed(generator),
            scale=scale, kv_valid=kv_valid,
            key_mask=None if mask is None else mask[:, 0, 0, :])
    if bias is None and is_key_padding and dropout_rate == 0.0:
        return flash_attention(q, k, v, kv_mask=mask[:, 0, 0, :],
                               scale=scale, kv_valid=kv_valid)
    if bias is not None and bias.shape[0] not in (1, q.shape[0]):
        # windowed attention: bias leading dim is num_windows, batch is
        # B·num_windows; batch b reads bias[b % num_windows]
        if q.shape[0] % bias.shape[0]:
            raise ValueError(f"bias batch {bias.shape[0]} does not divide "
                             f"{q.shape[0]}")
        bias = bias.repeat(q.shape[0] // bias.shape[0], 1, 1, 1)
    if kv_valid is not None and kv_valid < k.shape[2]:
        key_mask = (torch.arange(k.shape[2], device=q.device)
                    < kv_valid)[None, None, None, :]
        mask = key_mask if mask is None else (mask & key_mask)
    return mha_reference(q, k, v, bias, mask, scale=scale,
                         dropout_rate=dropout_rate, generator=generator)


class SelfAttention(nn.Module):
    """Packed-QKV multi-head self attention (torch MHA semantics).

    ``qkv`` is one Dense with columns [q | k | v]; ``out`` projects back.
    ``forward(x, return_weights=True)`` also returns the (B, H, S, S)
    probabilities (plain math, as in the JAX package). In training mode
    with ``attention_dropout`` > 0, ``forward`` needs ``seed``, the host
    integer its dropout mask is made from: the caller draws it, so that a
    recomputed forward (``remat``) replays the same mask. ``quant8``
    (serving): ``qkv`` and ``out`` are ``QuantDense`` (w8a8, ``ops/quant.py``);
    ``qkv``'s output keeps ``dtype``, so the attention keeps its route.
    Under tensor parallelism (``parallel.shard_params``) ``tp`` is set, and
    ``qkv`` holds this rank's heads of q, k and v (``num_heads`` and
    ``hidden_dim`` are then the rank's share) and ``out`` their rows.
    """

    tp = None

    def __init__(self, hidden_dim: int, num_heads: int,
                 attention_dropout: float = 0.0, out_bias: bool = True, *,
                 dtype: torch.dtype = torch.float32, quant8: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError("hidden_dim not divisible by heads")
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.attention_dropout = attention_dropout
        if quant8:
            self.qkv = QuantDense(hidden_dim, 3 * hidden_dim, dtype=dtype)
            self.out = QuantDense(hidden_dim, hidden_dim, bias=out_bias,
                                  dtype=dtype)
        else:
            self.qkv = Dense(hidden_dim, 3 * hidden_dim, dtype=dtype,
                             generator=generator)
            self.out = Dense(hidden_dim, hidden_dim, bias=out_bias,
                             dtype=dtype, generator=generator)

    def tp_divides(self, size: int) -> bool:
        return self.num_heads % size == 0 and isinstance(self.qkv, Dense)

    def tp_shard(self, tp) -> None:
        self.qkv = ColumnParallelDense(self.qkv, tp, parts=3)
        self.out = RowParallelDense(self.out, tp)
        self.num_heads //= tp.size
        self.hidden_dim //= tp.size
        self.tp = tp

    def forward(self, x: torch.Tensor, return_weights: bool = False, *,
                seed: Optional[int] = None):
        b, s, _ = x.shape
        h = self.num_heads
        dh = self.hidden_dim // h
        qkv = self.qkv(x)
        drop = self.attention_dropout if self.training else 0.0
        if drop > 0.0 and seed is None:
            raise ValueError("attention dropout in training mode needs a seed")
        if self.tp is not None:
            seed = self.tp.seed(seed)
        weights = None

        if (not return_weights
                and packed_flash_supported(b, s, qkv.shape[-1],
                                           qkv.element_size())):
            # the kernel reads the projection output in place: no head
            # split; dropout runs inside it
            out = packed_flash_attention(
                qkv, h, dropout_rate=drop, seed=seed if drop > 0.0 else None)
        else:
            q, k, v = (t.reshape(b, s, h, dh).transpose(1, 2).contiguous()
                       for t in qkv.split(self.hidden_dim, dim=-1))
            if return_weights:
                scores = torch.matmul(q.float(),
                                      k.float().transpose(-1, -2)) * dh ** -0.5
                weights = torch.softmax(scores, dim=-1)
                out = torch.matmul(weights.to(v.dtype).float(),
                                   v.float()).to(v.dtype)
            else:
                gen = (torch.Generator().manual_seed(seed) if drop > 0.0
                       else None)
                out = dot_product_attention(q, k, v, dropout_rate=drop,
                                            generator=gen)
            out = out.transpose(1, 2).reshape(b, s, self.hidden_dim)
        out = self.out(out)
        if return_weights:
            return out, weights
        return out
