"""Expert parallelism: a top-1 MoE MLP with its experts split over a mesh axis.

Counterpart of ``vision_transformers_tpu/parallel/expert.py``: a Switch-style
routed MLP with dense dispatch. Every expert's MLP runs on the whole token
set and a one-hot gate picks each token's expert output; with the experts
split over an axis each rank holds and runs only its E/n experts, and a sum
over the axis combines the winners.

The tensors keep the JAX layout: x (T, D), router_kernel (D, E), w1 (E, D,
H), b1 (E, H), w2 (E, H, D), b2 (E, D). The GELU is ``jax.nn.gelu``'s
default, the tanh approximation.

The JAX ``psum`` becomes ``reduce_from_group``: forward all-reduce, backward
identity. Every rank holds the same loss of the summed output, so the
gradient of each rank's part is that loss's gradient as it is;
``torch.distributed.nn.functional.all_reduce`` would sum the n ranks'
copies of it in its backward and give n times the gradient. The whole
inputs enter through ``copy_to_group`` (x, router) and ``split_to_group``
(the experts), so their gradients come out whole on every rank, as the JAX
function's do.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from vision_transformers_tpu_torch.parallel.mesh import (
    Mesh,
    check_mesh,
    copy_to_group,
    reduce_from_group,
    split_to_group,
)


def _route(x, router_kernel):
    probs = torch.softmax(x @ router_kernel, dim=-1)   # (T, E)
    expert = probs.argmax(dim=-1)                      # (T,)
    gate = probs.gather(-1, expert[:, None])           # (T, 1)
    return expert, gate


def _expert(x, w1, b1, w2, b2):
    return F.gelu(x @ w1 + b1, approximate="tanh") @ w2 + b2


def moe_mlp_reference(x, router_kernel, w1, b1, w2, b2):
    """Dense one-device oracle: top-1 routing, the winning expert's output
    scaled by its softmax gate probability."""
    expert, gate = _route(x, router_kernel)
    out = torch.zeros_like(x)
    for j in range(w1.shape[0]):
        sel = (expert == j)[:, None].to(x.dtype)
        out = out + sel * _expert(x, w1[j], b1[j], w2[j], b2[j])
    return out * gate


def moe_mlp_local(x, router_kernel, w1, b1, w2, b2, axis_name):
    """EP body on this rank; ``axis_name`` is the expert axis's process
    group. x and the router are whole; w1/b1/w2/b2 are this rank's E/n
    experts. The routing runs (redundantly) on every rank, each rank runs
    its experts on the tokens routed to them, and the sum over the axis
    combines them."""
    idx = dist.get_rank(axis_name)
    e_local = w1.shape[0]
    expert, gate = _route(x, router_kernel)
    first = idx * e_local
    out = torch.zeros_like(x)
    for j in range(e_local):
        sel = (expert == first + j)[:, None].to(x.dtype)
        out = out + sel * _expert(x, w1[j], b1[j], w2[j], b2[j])
    return reduce_from_group(out * gate, axis_name)


def expert_parallel_mlp(x: torch.Tensor, router_kernel: torch.Tensor,
                        w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                        b2: torch.Tensor, mesh: Mesh,
                        expert_axis: str = "expert") -> torch.Tensor:
    """The MoE MLP with experts split over ``expert_axis`` (its size must
    divide E); every input whole on every rank, the output whole too."""
    check_mesh(mesh)
    group = mesh.group(expert_axis)
    n = mesh.shape[expert_axis]
    if w1.shape[0] % n:
        raise ValueError(f"{w1.shape[0]} experts do not split over {n} "
                         "ranks")
    xs = copy_to_group(x, group)
    rk = copy_to_group(router_kernel, group)
    w1, b1, w2, b2 = (split_to_group(t, 0, group) for t in (w1, b1, w2, b2))
    return moe_mlp_local(xs, rk, w1, b1, w2, b2, group)
