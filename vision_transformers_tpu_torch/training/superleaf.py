"""Superleaf Adam: the whole optimizer state as ONE flat fp32 buffer.

Counterpart of ``vision_transformers_tpu/training/superleaf.py``:

- the master weights, Adam's mu and Adam's nu each live in one flat fp32
  tensor, padded to a multiple of ``_PAD_MULTIPLE`` elements;
- the forward reads the model's parameters as views of the flat master
  (``torch.split`` of it, reshaped) through ``torch.func.functional_call``,
  so the backward's gradient of the flat master is the flat gradient itself,
  gathered by one concatenation (``split``'s backward);
- the Adam update is ONE launch of the multi-tensor Adam kernel
  (``ops/fused_adam.py``, ``csrc/fused_adam.cu``) over the flat buffers as
  a single leaf; on the CPU its plain version, ``fused_adam_reference``.

Whether the views, the concatenation and the one launch beat the per-leaf
fused step (``make_optimizer(fused=True)``, also one launch) is the
keep-or-kill question of the JAX module; ``chip_smoke.py`` times both on the
card. Single device only, as in the JAX package: one flat buffer cannot
carry per-leaf shardings.

What differs: the state's tensors are updated in place (the JAX function
returns new arrays), and the train step takes no key: dropout seeds come
from the model's ``dropout_generator``, drawn as ``training.trainer.fit``
draws them, so a step can be held against the per-leaf path with the same
masks.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from vision_transformers_tpu_torch.ops.fused_adam import FusedAdamLeaves
from vision_transformers_tpu_torch.parallel.mesh import is_tp_sharded

_ROW = 1024
# the JAX package pads to whole 128-row blocks of 1024 elements
_PAD_MULTIPLE = _ROW * 128


class SuperleafMeta(NamedTuple):
    names: tuple             # parameter names, in the flat buffer's order
    shapes: tuple            # per-leaf shapes
    offsets: tuple           # per-leaf start offsets into the flat buffer
    sizes: tuple
    total_padded: int


class SuperleafState(NamedTuple):
    step: int                # Adam steps taken
    flat: torch.Tensor       # fp32[total_padded] master weights
    mu: torch.Tensor
    nu: torch.Tensor


def build_meta(params: Mapping[str, torch.Tensor]) -> SuperleafMeta:
    """The layout of ``params`` (name → tensor, e.g.
    ``dict(model.named_parameters())``) in the flat buffer; every leaf must
    be fp32."""
    for name, p in params.items():
        if p.dtype != torch.float32:
            raise ValueError(
                f"superleaf Adam requires fp32 param leaves, got {p.dtype} "
                f"for {name}")
    shapes = tuple(tuple(p.shape) for p in params.values())
    sizes = tuple(p.numel() for p in params.values())
    offsets, off = [], 0
    for s in sizes:
        offsets.append(off)
        off += s
    total_padded = -(-off // _PAD_MULTIPLE) * _PAD_MULTIPLE
    return SuperleafMeta(tuple(params), shapes, tuple(offsets), sizes,
                         total_padded)


def flatten_tree(tree: Mapping[str, torch.Tensor],
                 meta: SuperleafMeta) -> torch.Tensor:
    """The leaves of ``tree``, in ``meta``'s order, as one zero-padded flat
    fp32 tensor."""
    leaves = [tree[name].detach().reshape(-1).float() for name in meta.names]
    pad = meta.total_padded - sum(meta.sizes)
    if pad:
        leaves.append(leaves[0].new_zeros(pad))
    return torch.cat(leaves)


def unflatten_tree(flat: torch.Tensor,
                   meta: SuperleafMeta) -> Dict[str, torch.Tensor]:
    """name → view of ``flat`` in the leaf's shape. One ``split``, so the
    gradient of the views reaches ``flat`` as one concatenation."""
    parts = torch.split(flat, list(meta.sizes)
                        + [meta.total_padded - sum(meta.sizes)])
    return {name: part.view(shape) for name, part, shape
            in zip(meta.names, parts, meta.shapes)}


def init_state(params: Mapping[str, torch.Tensor],
               meta: Optional[SuperleafMeta] = None
               ) -> Tuple[SuperleafState, SuperleafMeta]:
    meta = meta or build_meta(params)
    flat = flatten_tree(params, meta)
    return SuperleafState(0, flat, torch.zeros_like(flat),
                          torch.zeros_like(flat)), meta


def adam_flat(state: SuperleafState, g_flat: torch.Tensor, lr: float,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
              weight_decay: float = 0.0) -> SuperleafState:
    """One Adam(W) step on the flat buffers, in place: on CUDA one launch of
    the Adam kernel over them as one leaf, with the scalars of
    ``ops.fused_adam.adam_scalars`` for step ``state.step + 1``."""
    FusedAdamLeaves([state.flat], [state.mu], [state.nu]).update(
        [g_flat], state.step + 1, lr, b1=b1, b2=b2, eps=eps,
        weight_decay=weight_decay)
    return state._replace(step=state.step + 1)


def superleaf_train_step_fn(model, meta: SuperleafMeta, lr: float,
                            normalize=None, b1: float = 0.9,
                            b2: float = 0.999, eps: float = 1e-8,
                            weight_decay: float = 0.0):
    """Train step over a ``SuperleafState``:
    ``step(state, images, labels, weights)`` → (state, loss·n, correct, n),
    the loss math of ``trainer.train_step_fn`` (CE with padding weights).
    The model's own parameters are not read: its forward runs on views of
    ``state.flat``."""
    from vision_transformers_tpu_torch.training.trainer import (
        _default_preprocess,
        _to_device,
        cross_entropy_with_weights,
        refuse_serving_only,
    )

    refuse_serving_only(model)
    if is_tp_sharded(model):
        # the JAX module's scope: one flat buffer cannot carry per-leaf TP
        # shards; the per-leaf optimizers (fit's) take them
        raise ValueError("superleaf Adam is for one device or data "
                         "parallelism: a model sharded by "
                         "parallel.shard_params trains through fit's "
                         "per-leaf optimizer")

    def step(state: SuperleafState, images, labels, weights):
        images, labels, weights = _to_device(state.flat.device, images,
                                             labels, weights)
        x = _default_preprocess(images, normalize)
        model.train()
        flat = state.flat.detach().requires_grad_()
        logits = torch.func.functional_call(
            model, unflatten_tree(flat, meta), (x,))
        loss = cross_entropy_with_weights(logits, labels, weights)
        (g_flat,) = torch.autograd.grad(loss, flat)
        state = adam_flat(state, g_flat, lr, b1=b1, b2=b2, eps=eps,
                          weight_decay=weight_decay)
        with torch.no_grad():
            pred = logits.argmax(dim=-1)
            correct = ((pred == labels) * weights).sum()
            n = weights.sum()
            return state, loss.detach() * n, correct, n

    return step
