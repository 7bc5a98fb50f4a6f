"""Sequence parallelism: ring attention over a mesh axis.

Counterpart of ``vision_transformers_tpu/parallel/sequence.py``. When one
device cannot hold a sequence's S² scores (COCO-scale DETR encoders), the
sequence is split over a mesh axis and the K/V blocks rotate around the
ring of that axis's ranks, one hop a step, while each rank accumulates its
queries' softmax online.

- ``ring_attention_local``: the per-rank body (JAX's ``shard_map`` body);
  its ``axis_name`` is the process group of the axis. The hop is
  ``dist.batch_isend_irecv`` inside an autograd function whose backward
  sends the gradient one hop the other way.
- ``sequence_parallel_attention``: takes q, k, v whole on every rank, keeps
  this rank's sequence block (and batch block with ``data_axis``), runs the
  ring and gathers the output whole: the port's counterpart of the JAX
  function's in/out specs (the gradient of a whole input is gathered whole,
  that of the output kept per block).
- ``sequence_sharding``: while active, the DETR encoder's self attention
  (``CrossAttention(sp_capable=True)``) rides ``sequence_parallel_attention``.

The body is the JAX package's fp32 online softmax, in ``torch.matmul`` (the
JAX body is einsums outside any Pallas kernel): masked scores are
``NEG_INF`` = −0.7·f32max, masked probabilities exactly 0, and l is clamped
at 1e-37, so a fully masked row comes out as zeros. Semantics match
``ops.attention.mha_reference`` with a key-padding mask.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from vision_transformers_tpu_torch.parallel.mesh import (
    Mesh,
    check_mesh,
    gather_from_group,
    ring_shift,
    shift,
    split_to_group,
)

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


class SequenceShardingCtx(NamedTuple):
    mesh: Mesh
    seq_axis: str
    data_axis: Optional[str]


_SEQ_CTX: list = []


@contextlib.contextmanager
def sequence_sharding(mesh: Mesh, seq_axis: str = "seq",
                      data_axis: Optional[str] = None):
    """Route the self attention of SP-aware modules (the DETR encoder)
    through ring attention over ``mesh`` 's ``seq_axis`` while active.
    Modules take their ordinary route when the sequence does not divide the
    axis or dropout is active.

        with sequence_sharding(mesh, "seq"):
            out = detr(images, masks)
    """
    _SEQ_CTX.append(SequenceShardingCtx(check_mesh(mesh), seq_axis,
                                        data_axis))
    try:
        yield
    finally:
        _SEQ_CTX.pop()


def current_sequence_sharding() -> Optional[SequenceShardingCtx]:
    return _SEQ_CTX[-1] if _SEQ_CTX else None


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         axis_name, kv_mask: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention body on this rank's blocks.

    q, k, v: (B, H, S_local, D); ``axis_name``: the process group of the
    sequence axis; kv_mask: optional (B, S_local) bool, True = key
    attendable. Returns (B, H, S_local, D): softmax(QKᵀ)V over all the
    ring's keys for the local queries, accumulated online over the n
    steps."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    n = torch.distributed.get_world_size(axis_name)
    b, h, s_loc, d = q.shape
    qf = q.float()
    m = torch.full((b, h, s_loc, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, s_loc, 1), device=q.device)
    acc = torch.zeros((b, h, s_loc, d), device=q.device)
    k_blk, v_blk = k, v
    mask_blk = None if kv_mask is None else kv_mask.to(torch.uint8)
    for step in range(n):
        s = torch.matmul(qf, k_blk.float().transpose(-1, -2)) * scale
        keep = None
        if mask_blk is not None:
            keep = mask_blk.bool()[:, None, None, :]
            s = torch.where(keep, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        if keep is not None:
            # exp(NEG_INF - NEG_INF) = 1 where a whole row is masked so
            # far; masked keys must contribute exactly zero mass
            p = torch.where(keep, p, torch.zeros_like(p))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, v_blk.float())
        m = m_new
        if step + 1 < n:  # one hop around the ring (none after the last)
            k_blk, v_blk = shift((k_blk, v_blk), axis_name, 1)
            if mask_blk is not None:
                (mask_blk,) = ring_shift((mask_blk,), axis_name, 1)
    # all-padding rows (fully masked) have l == 0: zeros, not NaN
    out = acc / torch.clamp(l, min=1e-37)
    return out.to(q.dtype)


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, mesh: Mesh,
                                seq_axis: str = "seq",
                                data_axis: Optional[str] = None,
                                kv_mask: Optional[torch.Tensor] = None,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Sequence-parallel attention over ``mesh``.

    q, k, v: (B, H, S, D), whole on every rank; the ``seq_axis`` size must
    divide S (pad and mask what is ragged), the ``data_axis`` size (if
    given) B. kv_mask: optional (B, S) bool, True = attendable. Returns the
    whole (B, H, S, D) on every rank."""
    check_mesh(mesh)
    seq = mesh.group(seq_axis)
    data = mesh.group(data_axis) if data_axis is not None else None

    def split(t, seq_dim):
        if data is not None:
            t = split_to_group(t, 0, data)
        return split_to_group(t, seq_dim, seq)

    mask = None
    if kv_mask is not None:
        mask = kv_mask.bool()
        if data is not None:
            mask = split_to_group(mask, 0, data)
        mask = split_to_group(mask, 1, seq)
    out = ring_attention_local(split(q, 2), split(k, 2), split(v, 2), seq,
                               kv_mask=mask, scale=scale)
    out = gather_from_group(out, 2, seq)
    if data is not None:
        out = gather_from_group(out, 0, data)
    return out
