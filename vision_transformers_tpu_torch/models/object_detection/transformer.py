"""DETR encoder-decoder transformer.

Counterpart of ``vision_transformers_tpu/models/object_detection/
transformer.py``: encoder layers with the positional embedding added at Q
and K only, decoder layers with query-pos self attention and cross
attention into the encoder memory, pre-norm or post-norm, a
``return_intermediate`` decoder for the aux losses, xavier init. Batch-first
(B, S, D); key-padding masks (True = padding) flow as keep-masks into
``ops.attention.dot_product_attention``, whose kernels take them: at rate 0
the streaming kernel (``flash_attention(kv_mask=...)``), with dropout the
split-head dropout kernel; the mask-free decoder self attention takes the
split-head kernel.

Dropout is seeded: ``Transformer`` draws one host integer per layer and
forward from its ``dropout_generator`` in training mode, and every mask of
a layer (the attention kernels' and the elementwise dropouts') is made from
that integer (seed + site), as in the port's ViT.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vision_transformers_tpu_torch.ops.attention import dot_product_attention
from vision_transformers_tpu_torch.ops.layers import Dense, Dropout, LayerNorm
from vision_transformers_tpu_torch.parallel.mesh import (
    ColumnParallelDense,
    RowParallelDense,
)
from vision_transformers_tpu_torch.parallel.sequence import (
    current_sequence_sharding,
    sequence_parallel_attention,
)


def _sub(seed: Optional[int]) -> Callable[[int], Optional[int]]:
    return (lambda i: None) if seed is None else (lambda i: seed + i)


class CrossAttention(nn.Module):
    """MHA with separate query/key/value inputs and a key-padding mask.

    ``sp_capable`` is set on the encoder's self attention only: while a
    ``parallel.sequence_sharding(mesh)`` context is active, the sequence
    divides the mesh's seq axis, q and k have one length and dropout is off,
    the softmax runs as ring attention over that axis
    (``parallel.sequence_parallel_attention``); otherwise it takes the
    ordinary route. Under tensor parallelism (``parallel.shard_params``)
    ``tp`` is set: the three input projections hold this rank's heads
    (``nhead`` and ``d_model`` are its share) and ``out_proj`` their rows.
    """

    tp = None

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0,
                 sp_capable: bool = False, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if d_model % nhead:
            raise ValueError("d_model not divisible by nhead")
        self.d_model, self.nhead = d_model, nhead
        self.dropout = dropout
        self.sp_capable = sp_capable
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(d_model, d_model, dtype=dtype,
                                        generator=generator))

    def tp_divides(self, size: int) -> bool:
        return self.nhead % size == 0

    def tp_shard(self, tp) -> None:
        for name in ("q_proj", "k_proj", "v_proj"):
            setattr(self, name, ColumnParallelDense(getattr(self, name), tp))
        self.out_proj = RowParallelDense(self.out_proj, tp)
        self.nhead //= tp.size
        self.d_model //= tp.size
        self.tp = tp

    def forward(self, q_in: torch.Tensor, k_in: torch.Tensor,
                v_in: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                seed: Optional[int] = None) -> torch.Tensor:
        b, sq, _ = q_in.shape
        sk = k_in.shape[1]
        h = self.nhead
        dh = self.d_model // h
        heads = lambda t, s: t.reshape(b, s, h, dh).transpose(1, 2).contiguous()  # noqa: E731
        q = heads(self.q_proj(q_in), sq)
        k = heads(self.k_proj(k_in), sk)
        v = heads(self.v_proj(v_in), sk)
        mask = None
        if key_padding_mask is not None:
            # (B, Sk) True = PADDING (torch convention) → keep-mask
            mask = ~key_padding_mask[:, None, None, :]
        drop = self.dropout if self.training else 0.0
        if self.sp_capable and sq == sk and drop == 0.0:
            ctx = current_sequence_sharding()
            if ctx is not None and sk % ctx.mesh.shape[ctx.seq_axis] == 0:
                out = sequence_parallel_attention(
                    q, k, v, ctx.mesh, seq_axis=ctx.seq_axis,
                    data_axis=ctx.data_axis,
                    kv_mask=(None if key_padding_mask is None
                             else ~key_padding_mask))
                return self.out_proj(
                    out.transpose(1, 2).reshape(b, sq, self.d_model))
        gen = None
        if drop > 0.0:
            if seed is None:
                raise ValueError("attention dropout in training mode needs a "
                                 "seed")
            gen = torch.Generator().manual_seed(
                seed if self.tp is None else self.tp.seed(seed))
        out = dot_product_attention(q, k, v, mask=mask, dropout_rate=drop,
                                    generator=gen)
        return self.out_proj(out.transpose(1, 2).reshape(b, sq, self.d_model))


_ACTIVATIONS = {"relu": F.relu, "glu": lambda x: F.glu(x, dim=-1),
                "gelu": lambda x: F.gelu(x, approximate="none")}


class _Layer(nn.Module):
    """What the encoder and decoder layers share: the FFN (linear1 →
    activation → dropout → linear2, the JAX names) and the dropout. Under
    tensor parallelism ``linear1`` is column-parallel (GLU: both halves
    split alike) and ``linear2`` row-parallel."""

    tp = None

    def tp_divides(self, size: int) -> bool:
        return self.linear2.weight.shape[1] % size == 0

    def tp_shard(self, tp) -> None:
        glu = self.linear1.weight.shape[0] != self.linear2.weight.shape[1]
        self.linear1 = ColumnParallelDense(self.linear1, tp,
                                           parts=2 if glu else 1)
        self.linear2 = RowParallelDense(self.linear2, tp)
        self.tp = tp

    def _init_ffn(self, d_model, dim_feedforward, dropout, activation, dtype,
                  generator):
        if activation not in _ACTIVATIONS:
            raise ValueError(f"activation {activation!r}: one of "
                             f"{sorted(_ACTIVATIONS)}")
        self.act = _ACTIVATIONS[activation]
        self.linear1 = Dense(d_model, dim_feedforward, dtype=dtype,
                             generator=generator)
        hidden = dim_feedforward // 2 if activation == "glu" \
            else dim_feedforward
        self.linear2 = Dense(hidden, d_model, dtype=dtype, generator=generator)
        self.drop = Dropout(dropout)

    def _ffn(self, x, seed):
        if self.tp is not None:
            seed = self.tp.seed(seed)
        return self.linear2(self.drop(self.act(self.linear1(x)), seed))


class TransformerEncoderLayer(_Layer):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, activation: str = "relu",
                 normalize_before: bool = False, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = CrossAttention(d_model, nhead, dropout,
                                        sp_capable=True, dtype=dtype,
                                        generator=generator)
        self.norm1 = LayerNorm(d_model, eps=1e-6, dtype=dtype)
        self.norm2 = LayerNorm(d_model, eps=1e-6, dtype=dtype)
        self._init_ffn(d_model, dim_feedforward, dropout, activation, dtype,
                       generator)

    def forward(self, src, src_key_padding_mask=None, pos=None,
                seed: Optional[int] = None):
        """``seed``: the layer's dropout seed for this forward (training
        only); its masks are made from seed .. seed + 3."""
        sub = _sub(seed)
        with_pos = (lambda x: x) if pos is None else (lambda x: x + pos)
        if self.normalize_before:
            y = self.norm1(src)
            y = self.self_attn(with_pos(y), with_pos(y), y,
                               src_key_padding_mask, sub(0))
            src = src + self.drop(y, sub(1))
            return src + self.drop(self._ffn(self.norm2(src), sub(2)), sub(3))
        y = self.self_attn(with_pos(src), with_pos(src), src,
                           src_key_padding_mask, sub(0))
        src = self.norm1(src + self.drop(y, sub(1)))
        return self.norm2(src + self.drop(self._ffn(src, sub(2)), sub(3)))


class TransformerDecoderLayer(_Layer):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, activation: str = "relu",
                 normalize_before: bool = False, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.normalize_before = normalize_before
        kw = dict(dtype=dtype, generator=generator)
        self.self_attn = CrossAttention(d_model, nhead, dropout, **kw)
        self.multihead_attn = CrossAttention(d_model, nhead, dropout, **kw)
        for name in ("norm1", "norm2", "norm3"):
            self.add_module(name, LayerNorm(d_model, eps=1e-6, dtype=dtype))
        self._init_ffn(d_model, dim_feedforward, dropout, activation, dtype,
                       generator)

    def forward(self, tgt, memory, memory_key_padding_mask=None, pos=None,
                query_pos=None, seed: Optional[int] = None):
        """``seed``: the layer's dropout seed for this forward (training
        only); its masks are made from seed .. seed + 5."""
        sub = _sub(seed)
        with_qpos = (lambda x: x) if query_pos is None \
            else (lambda x: x + query_pos)
        with_pos = (lambda x: x) if pos is None else (lambda x: x + pos)
        if self.normalize_before:
            y = self.norm1(tgt)
            y = self.self_attn(with_qpos(y), with_qpos(y), y, None, sub(0))
            tgt = tgt + self.drop(y, sub(1))
            y = self.norm2(tgt)
            y = self.multihead_attn(with_qpos(y), with_pos(memory), memory,
                                    memory_key_padding_mask, sub(2))
            tgt = tgt + self.drop(y, sub(3))
            return tgt + self.drop(self._ffn(self.norm3(tgt), sub(4)), sub(5))
        y = self.self_attn(with_qpos(tgt), with_qpos(tgt), tgt, None, sub(0))
        tgt = self.norm1(tgt + self.drop(y, sub(1)))
        y = self.multihead_attn(with_qpos(tgt), with_pos(memory), memory,
                                memory_key_padding_mask, sub(2))
        tgt = self.norm2(tgt + self.drop(y, sub(3)))
        return self.norm3(tgt + self.drop(self._ffn(tgt, sub(4)), sub(5)))


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int, nhead: int, num_layers: int,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 activation: str = "relu", normalize_before: bool = False, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                normalize_before, dtype=dtype, generator=generator))
        self.norm = (LayerNorm(d_model, eps=1e-6, dtype=dtype)
                     if normalize_before else None)

    def forward(self, src, src_key_padding_mask=None, pos=None,
                seeds: Optional[List[Optional[int]]] = None):
        seeds = seeds or [None] * self.num_layers
        out = src
        for i in range(self.num_layers):
            out = getattr(self, f"layer{i}")(out, src_key_padding_mask, pos,
                                             seeds[i])
        return out if self.norm is None else self.norm(out)


class TransformerDecoder(nn.Module):
    def __init__(self, d_model: int, nhead: int, num_layers: int,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 activation: str = "relu", normalize_before: bool = False,
                 return_intermediate: bool = False, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        self.return_intermediate = return_intermediate
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                normalize_before, dtype=dtype, generator=generator))
        self.norm = LayerNorm(d_model, eps=1e-6, dtype=dtype)

    def forward(self, tgt, memory, memory_key_padding_mask=None, pos=None,
                query_pos=None, seeds: Optional[List[Optional[int]]] = None):
        seeds = seeds or [None] * self.num_layers
        out = tgt
        intermediate = []
        for i in range(self.num_layers):
            out = getattr(self, f"layer{i}")(
                out, memory, memory_key_padding_mask, pos, query_pos,
                seeds[i])
            if self.return_intermediate:
                intermediate.append(self.norm(out))
        if self.return_intermediate:
            return torch.stack(intermediate)  # (L, B, Q, D)
        return self.norm(out)[None]


class Transformer(nn.Module):
    """The DETR transformer.

    ``forward(src, mask, query_embed, pos_embed)`` with src (B, H, W, C)
    NHWC, mask (B, H, W) True = padding (or None), query_embed (Q, D),
    pos_embed (B, H, W, C). Returns (hs (L|1, B, Q, D), memory
    (B, H, W, C)). In training mode with ``dropout`` > 0 it draws its layer
    seeds from ``dropout_generator`` (a host generator; a new one unless
    given)."""

    def __init__(self, d_model: int = 512, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 activation: str = "relu", normalize_before: bool = False,
                 return_intermediate_dec: bool = False, *,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d_model = d_model
        self.dropout = dropout
        self.dropout_generator = (torch.Generator() if dropout_generator is None
                                  else dropout_generator)
        kw = dict(dtype=dtype, generator=generator)
        self.encoder = TransformerEncoder(
            d_model, nhead, num_encoder_layers, dim_feedforward, dropout,
            activation, normalize_before, **kw)
        self.decoder = TransformerDecoder(
            d_model, nhead, num_decoder_layers, dim_feedforward, dropout,
            activation, normalize_before, return_intermediate_dec, **kw)

    def _seeds(self) -> Tuple[Optional[list], Optional[list]]:
        n_enc, n_dec = self.encoder.num_layers, self.decoder.num_layers
        if not (self.training and self.dropout > 0.0):
            return None, None
        # one host draw per forward: no device synchronisation
        seeds = torch.randint(0, 2 ** 62, (n_enc + n_dec,),
                              generator=self.dropout_generator).tolist()
        return seeds[:n_enc], seeds[n_enc:]

    def forward(self, src, mask, query_embed, pos_embed):
        b, h, w, c = src.shape
        src_seq = src.reshape(b, h * w, c)
        pos_seq = pos_embed.reshape(b, h * w, c)
        mask_seq = mask.reshape(b, h * w) if mask is not None else None
        query = query_embed[None].expand(b, *query_embed.shape)
        tgt = torch.zeros_like(query)
        enc_seeds, dec_seeds = self._seeds()
        memory = self.encoder(src_seq, mask_seq, pos_seq, enc_seeds)
        hs = self.decoder(tgt, memory, mask_seq, pos_seq, query, dec_seeds)
        return hs, memory.reshape(b, h, w, c)
