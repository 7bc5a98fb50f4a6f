"""Pipeline parallelism: GPipe-style microbatched stages over a mesh axis.

Counterpart of ``vision_transformers_tpu/parallel/pipeline.py``: the layer
stack splits into ``n_stages`` contiguous stages, one per rank along a
``stage`` mesh axis, and microbatches stream through them. Each schedule
step every stage applies itself to its current activation and passes the
result to the right neighbour (a send and a receive), while stage 0 feeds
the next microbatch in; after ``n_micro + n_stages − 1`` steps every
microbatch has crossed every stage, and the last stage holds the outputs,
which a sum over the axis hands to every rank. The schedule is the JAX
package's, dead drain work included.

``stage_fn(stage_params, activation)`` must keep the activation's shape
(true of transformer encoder stacks). In ``pipeline_apply`` the
parameters are stacked with a leading ``n_stages`` dim (any nesting of
lists, tuples and dicts of tensors) and each rank reads only its own index;
``vit_pipeline_forward`` runs only its stage's ``EncoderBlock``s on each
rank. Both are forward passes (inference and evaluation), as in the JAX
package.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from vision_transformers_tpu_torch.parallel.mesh import (
    Mesh,
    check_mesh,
    ring_shift,
)


@torch.no_grad()
def pipeline_local(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, microbatches: torch.Tensor,
                   axis_name) -> torch.Tensor:
    """The GPipe schedule on this rank; ``axis_name`` is the process group
    of the stage axis.

    microbatches: (n_micro, mb, ...), the whole input on every rank (only
    stage 0 reads it). Returns (n_micro, mb, ...) outputs, valid on the
    last stage and zeros elsewhere: sum over the stage axis (or read the
    last rank) to collect them."""
    n_stages = dist.get_world_size(axis_name)
    idx = dist.get_rank(axis_name)
    n_micro = microbatches.shape[0]
    act = torch.zeros_like(microbatches[0])
    outs = torch.zeros_like(microbatches)
    for t in range(n_micro + n_stages - 1):
        # stage 0 takes microbatch t (the last one again while draining);
        # the others the activation received from the left last step
        if idx == 0:
            act = microbatches[min(t, n_micro - 1)]
        y = stage_fn(stage_params, act)
        done = t - (n_stages - 1)  # the last stage finishes it at step t
        if idx == n_stages - 1 and done >= 0:
            outs[done] = y
        (act,) = ring_shift((y,), axis_name, 1)
    return outs


@torch.no_grad()
def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stacked_params: Any, x: torch.Tensor, mesh: Mesh,
                   stage_axis: str = "stage", n_micro: Optional[int] = None,
                   data_axis: Optional[str] = None) -> torch.Tensor:
    """Run ``x`` through an ``n_stages``-deep pipeline over ``mesh``.

    stacked_params: leaves with a leading ``n_stages`` dim (stage i at
    index i); this rank reads index ``mesh.coordinate(stage_axis)``.
    x: (B, ...), whole on every rank, split into ``n_micro`` microbatches
    (default: one per stage). ``data_axis`` also splits each microbatch's
    batch dim over that axis (DP×PP: each data slice runs its own pipeline
    over the same stages). Returns the whole (B, ...) on every rank."""
    check_mesh(mesh)
    me = mesh.coordinate(stage_axis)
    return _run_stages(stage_fn,
                       pytree.tree_map(lambda a: a[me], stacked_params), x,
                       mesh, stage_axis, n_micro, data_axis)


def _run_stages(stage_fn, local_params, x, mesh, stage_axis, n_micro,
                data_axis):
    """``pipeline_apply`` given this rank's stage parameters."""
    n_stages = mesh.shape[stage_axis]
    n_micro = n_micro or n_stages
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         "microbatches")
    micro = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
    data = None
    if data_axis is not None:
        data = mesh.group(data_axis)
        n = mesh.shape[data_axis]
        per = micro.shape[1] // n
        if micro.shape[1] % n:
            raise ValueError(f"microbatch {micro.shape[1]} does not split "
                             f"over {n} data ranks")
        micro = micro[:, mesh.coordinate(data_axis) * per:][:, :per]
    group = mesh.group(stage_axis)
    outs = pipeline_local(stage_fn, local_params, micro.contiguous(), group)
    # only the last stage holds outputs; the sum hands them to every rank
    dist.all_reduce(outs, group=group)
    if data is not None:
        parts = [torch.empty_like(outs) for _ in range(mesh.shape[data_axis])]
        dist.all_gather(parts, outs, group=data)
        outs = torch.cat(parts, dim=1)
    return outs.reshape((b,) + tuple(x.shape[1:]))


@torch.no_grad()
def vit_pipeline_forward(model, params: Optional[dict], images: torch.Tensor,
                         mesh: Mesh, stage_axis: str = "stage",
                         data_axis: Optional[str] = None,
                         n_micro: Optional[int] = None) -> torch.Tensor:
    """The ViT forward with its encoder stack pipelined over
    ``mesh[stage_axis]``; equal to ``model(images)`` in eval mode.

    Stage i runs blocks [i·L/S, (i+1)·L/S) and this rank runs only its
    own stage's blocks. The patch embedding, class token and position
    embedding run on every rank before the pipeline, the final LN and the
    head after it. ``params``: a state dict to load into ``model`` first,
    or None for its own weights. ``data_axis``, ``n_micro`` as in
    ``pipeline_apply``. Deterministic (eval-mode) forward."""
    check_mesh(mesh)
    if params is not None:
        model.load_state_dict(params)
    model.eval()
    n_stages = mesh.shape[stage_axis]
    enc = model.encoder
    n_layers = enc.num_layers
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} "
                         "stages")
    per = n_layers // n_stages
    me = mesh.coordinate(stage_axis)
    mine = [getattr(enc, f"encoder_layer_{i}")
            for i in range(me * per, (me + 1) * per)]

    tokens, _ = model.conv_proj(images)
    cls = model.class_token.to(tokens.dtype).expand(
        tokens.shape[0], 1, model.hidden_dim)
    x = torch.cat([cls, tokens], dim=1)
    x = x + enc.pos_embedding.to(x.dtype)

    def stage_fn(blocks, act):
        for block in blocks:
            act = block(act)
        return act

    y = _run_stages(stage_fn, mine, x, mesh, stage_axis, n_micro,
                    data_axis)
    return model.head(enc.ln(y)[:, 0])
