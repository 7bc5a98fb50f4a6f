"""Device mesh over ranks, the tensor-parallel rules, and the collectives.

Counterpart of ``vision_transformers_tpu/parallel/mesh.py``. The JAX package
runs one process over many devices, and parallelism there is a sharding
annotation that XLA turns into collectives. PyTorch has no single-process
SPMD, so the port's mesh is a mesh of processes, one device each
(``torch.distributed.device_mesh.init_device_mesh``), and what XLA inserts
the port writes out:

- **DP** (axis ``data``): every rank reads the same global batch and keeps
  its slice of the batch axis (``DataParallel.local``); outputs are
  gathered back (``DataParallel.gather``, whose backward keeps the rank's
  rows), so every rank computes the loss of the whole batch, and the
  gradients are summed over the axis (``DataParallel.all_reduce_grads``).
- **TP** (axis ``model``): explicit Megatron. ``shard_params`` keeps on each
  rank its slice of every column-parallel projection (q/k/v, fc1) and
  row-parallel one (out, fc2) and puts two collectives around them as
  autograd functions: entering a column-parallel Dense, forward identity
  and backward all-reduce (``copy_to_group``); after a row-parallel Dense,
  forward all-reduce and backward identity (``reduce_from_group``), with
  the bias added once after the reduce. Attention modules then run H/tp
  local heads through the same kernels.

The rules (``param_partition_spec``) are JAX's, on the port's parameter
names: the names mirror JAX's tree with dots for slashes, a Dense's
``weight`` is torch's (out, in), the transpose of JAX's (in, out)
``kernel``, and LayerNorm's ``scale`` is ``weight``. So a column-parallel
rule shards a ``weight``'s dim 0 and a row-parallel rule its dim 1, while the
raw window-attention kernels (``qkv_kernel``, ``proj_kernel``), which keep
flax's (in, out) layout in the port, take JAX's specs as they are. A spec is
a tuple with one entry per dim, the axis name or None (JAX's
``PartitionSpec``).

``batch_sharding(mesh)`` and ``replicated(mesh)`` keep JAX's names: the
first is the ``DataParallel`` of the mesh's ``data`` axis (a batch split
over it), the second a placement that keeps whole tensors on every rank.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

# ------------------------------------------------------------------ mesh


class Mesh:
    """A mesh of ranks with named axes (a ``DeviceMesh`` inside).

    ``shape`` maps each axis name to its size, as JAX's ``Mesh.shape`` does
    (``mesh.shape["data"]``); ``size`` is the number of ranks.
    ``group(axis)`` is the process group of this rank's line along the axis
    and ``coordinate(axis)`` this rank's index on it."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(
            zip(self.axis_names, device_mesh.shape))
        self.size = int(device_mesh.size())

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        return int(self.device_mesh.get_local_rank(axis))

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data", "model")) -> Mesh:
    """A mesh over every rank of the process group
    (``parallel.init_distributed_mode`` makes it). Default: all ranks on
    the first axis. The shape's product must be the world size."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "parallel.init_distributed_mode first (torchrun's environment or "
            "its coordinator_address / num_processes / process_id)")
    world = dist.get_world_size()
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not name its axes "
                         f"{axis_names}")
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"mesh shape {shape} holds {n} ranks; the process "
                         f"group has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(init_device_mesh(device_type, shape,
                                 mesh_dim_names=axis_names))


def check_mesh(mesh) -> Mesh:
    """``mesh`` itself if it is the port's mesh; a clear error otherwise
    (a JAX ``Mesh`` has the same attribute names but no process groups)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be parallel.make_mesh's Mesh (a mesh of ranks), not "
            f"{type(mesh).__module__}.{type(mesh).__name__}")
    return mesh


# ---------------------------------------------------------- seeds per rank

_GOLDEN = 0x9E3779B97F4A7C15


def fold_seed(seed: int, index: int) -> int:
    """A dropout seed for the ``index``-th rank of an axis; index 0 keeps
    ``seed``, so a one-rank axis draws the masks of a run without a mesh."""
    return (int(seed) + int(index) * _GOLDEN) % (2 ** 62)


# ----------------------------------------------------- autograd collectives


def _ranks(group) -> List[int]:
    return dist.get_process_group_ranks(group)


def _group_size(group) -> int:
    return dist.get_world_size(group)


class _CopyTo(torch.autograd.Function):
    """Forward identity, backward all-reduce (sum) over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """Forward all-reduce (sum) over ``group``, backward identity."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_group_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _own_part(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _group_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over {n} ranks")
    per = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * per, per)


class _SplitTo(torch.autograd.Function):
    """Forward: this rank's part of a tensor every rank holds whole;
    backward: the parts' gradients gathered, so every rank gets the whole
    gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own_part(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _GatherFrom(torch.autograd.Function):
    """Forward: the ranks' parts gathered into the whole tensor; backward:
    this rank's part of the gradient (every rank holds the same whole
    gradient)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own_part(g, ctx.dim, ctx.group).contiguous(), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Enter a region whose ranks each compute a part of a sum: forward
    identity, backward all-reduce (Megatron's f)."""
    return _CopyTo.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Leave that region: forward all-reduce, backward identity (Megatron's
    g; JAX's ``psum`` over an axis whose result every rank holds)."""
    return _ReduceFrom.apply(x, group)


def split_to_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's equal part of ``x`` along ``dim`` (a ``shard_map`` in-spec
    over the group's axis); its backward gathers the gradient."""
    return _SplitTo.apply(x, dim, group)


def gather_from_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole tensor from each rank's part along ``dim`` (a ``shard_map``
    out-spec); its backward keeps this rank's part of the gradient."""
    return _GatherFrom.apply(x, dim, group)


class _Shift(torch.autograd.Function):
    """Send each tensor ``step`` ranks on around the group's ring and
    receive the one from ``step`` ranks back (JAX's ``ppermute`` with
    i → i + step); the backward sends the gradients the other way."""

    @staticmethod
    def forward(ctx, group, step, *xs):
        ctx.group, ctx.step = group, step
        return ring_shift(xs, group, step)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + ring_shift(gs, ctx.group, -ctx.step)


def ring_shift(xs: Sequence[torch.Tensor], group, step: int = 1
               ) -> Tuple[torch.Tensor, ...]:
    """One hop of a ring permute for every tensor of ``xs``, in one batch
    of sends and receives; no autograd (``shift`` is the differentiable
    one). A one-rank group returns the tensors as they are."""
    ranks = _ranks(group)
    n = len(ranks)
    xs = tuple(xs)
    if n == 1:
        return xs
    me = ranks.index(dist.get_rank())
    dst, src = ranks[(me + step) % n], ranks[(me - step) % n]
    xs = tuple(x.contiguous() for x in xs)
    outs = tuple(torch.empty_like(x) for x in xs)
    ops = []
    for x, y in zip(xs, outs):
        ops.append(dist.P2POp(dist.isend, x, dst, group))
        ops.append(dist.P2POp(dist.irecv, y, src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def shift(xs: Sequence[torch.Tensor], group, step: int = 1
          ) -> Tuple[torch.Tensor, ...]:
    """``ring_shift`` with gradients: the backward shifts them back."""
    if _group_size(group) == 1:
        return tuple(xs)
    return _Shift.apply(group, step, *xs)


# ----------------------------------------------------------------- TP rules

_TP_RULES = (
    (re.compile(r".*\.(qkv|q_proj|k_proj|v_proj|kv|q)\.weight$"),
     ("model", None)),
    (re.compile(r".*\.(qkv|q_proj|k_proj|v_proj|kv|q)\.bias$"), ("model",)),
    (re.compile(r".*qkv_kernel$"), (None, "model")),
    (re.compile(r".*qkv_bias$"), ("model",)),
    (re.compile(r".*\.(out|out_proj)\.weight$"), (None, "model")),
    (re.compile(r".*\.(fc1|linear1)\.weight$"), ("model", None)),
    (re.compile(r".*\.(fc1|linear1)\.bias$"), ("model",)),
    (re.compile(r".*\.(fc2|linear2)\.weight$"), (None, "model")),
)

# 'proj' is an out-projection only when its owning module also holds a
# q/kv/qkv projection (SRA, TNT's attentions); elsewhere (patch embeds) the
# same name is a replicated embedding projection.
_CTX_PROJ_WEIGHT = re.compile(r".*\.proj\.weight$")
_CTX_PROJ_KERNEL_RAW = re.compile(r".*\.proj_kernel$")
_QKV_OWNER = re.compile(r".*\.(qkv|q|kv)\.weight$")
_QKV_OWNER_RAW = re.compile(r".*qkv_kernel$")


def attention_prefixes(paths: Iterable[str]) -> set:
    """Module prefixes that own a q/kv/qkv projection parameter."""
    pref = set()
    for p in paths:
        if _QKV_OWNER.match(p):
            pref.add(p.rsplit(".", 2)[0])
        elif _QKV_OWNER_RAW.match(p):
            pref.add(p.rsplit(".", 1)[0])
    return pref


def param_partition_spec(path: str, attn_prefixes=()) -> Tuple:
    """The TP spec of the parameter named ``path`` (``()`` = replicated)."""
    for rule, spec in _TP_RULES:
        if rule.match(path):
            return spec
    if _CTX_PROJ_WEIGHT.match(path):
        if path.rsplit(".", 2)[0] in attn_prefixes:
            return (None, "model")
    elif _CTX_PROJ_KERNEL_RAW.match(path):
        if path.rsplit(".", 1)[0] in attn_prefixes:
            return ("model", None)
    return ()


def _named(params) -> List[Tuple[str, torch.Tensor]]:
    if isinstance(params, nn.Module):
        return list(params.named_parameters())
    return list(params.items())


def tree_paths(params) -> List[str]:
    """The parameter names of a module (or of a name → tensor mapping)."""
    return [name for name, _ in _named(params)]


# Parameters that are large but replicated on purpose under TP: the JAX
# package's list, anchored to word boundaries in a name.
_REPLICATED_OK_TOKENS = (
    "patch_embed", "pos_embed", "pos_embedding", "position", "embedding",
    "head", "cls_token", "class_token", "dist_token", "bias_table", "cpb",
    "backbone", "query", "conv", "downsample", "merge", "reduction",
    "norm", "sr", "input_proj", "ln",
)
_REPLICATED_OK = re.compile(
    r"(^|\.|_)(" + "|".join(_REPLICATED_OK_TOKENS) + r")\d*(_|\.|$)",
    re.IGNORECASE,
)


def audit_tp_coverage(params, mesh: Optional[Mesh] = None,
                      min_bytes: int = 1 << 20) -> List[str]:
    """Names of parameters of at least ``min_bytes`` that neither match a
    TP rule nor are on the replicated-on-purpose list: replication that a
    rule should cover. ``params``: a module or a name → tensor mapping."""
    named = _named(params)
    attn = attention_prefixes(name for name, _ in named)
    missed = []
    for name, leaf in named:
        if leaf.numel() * leaf.element_size() < min_bytes:
            continue
        if any(a is not None for a in param_partition_spec(name, attn)):
            continue
        if _REPLICATED_OK.search(name):
            continue
        missed.append(name)
    return missed


# --------------------------------------------------------------- TP modules


def _share(width: int, parts: int, size: int, rank: int) -> torch.Tensor:
    """The indices of rank ``rank``'s share (of ``size``) of each of
    ``parts`` consecutive blocks of ``width``."""
    per = width // size
    own = torch.arange(rank * per, (rank + 1) * per)
    return torch.cat([own + j * width for j in range(parts)])


@dataclass(frozen=True)
class TensorParallel:
    """This rank's place on the ``model`` axis, handed to the modules that
    ``shard_params`` shards (their ``tp``)."""

    group: Any
    size: int
    rank: int

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to_group(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from_group(x, self.group)

    def blocks(self, width: int, parts: int = 1) -> torch.Tensor:
        """The indices of this rank's share of each of ``parts``
        consecutive blocks of ``width``: a packed [q | k | v] projection
        gives each rank heads [r·H/tp, (r+1)·H/tp) of all three."""
        return _share(width, parts, self.size, self.rank)

    def seed(self, seed: Optional[int]) -> Optional[int]:
        """The seed of a dropout mask over this rank's heads or hidden
        units; replicated activations keep the block's seed."""
        return None if seed is None else fold_seed(seed, self.rank)


def shard_tensor(p: torch.Tensor, tp: TensorParallel, dim: int,
                 parts: int = 1) -> nn.Parameter:
    """This rank's share of a parameter along ``dim``, which holds
    ``parts`` blocks each split over the axis. The share carries
    ``_tp_layout`` = (dim, block width, parts, group): how to gather the
    whole tensor back and which ranks hold the other shares."""
    width = p.shape[dim] // parts
    q = nn.Parameter(p.detach().index_select(
        dim, tp.blocks(width, parts).to(p.device)).clone(),
        requires_grad=p.requires_grad)
    q._tp_layout = (dim, width, parts, tp.group)
    return q


class ColumnParallelDense(nn.Module):
    """A ``Dense`` whose output features are this rank's share: its input
    enters through ``tp.copy``. ``weight`` (out/tp, in), ``bias`` (out/tp)."""

    def __init__(self, dense: nn.Module, tp: TensorParallel, parts: int = 1):
        super().__init__()
        self.dtype, self.tp = dense.dtype, tp
        self.weight = shard_tensor(dense.weight, tp, 0, parts)
        self.bias = (None if dense.bias is None
                     else shard_tensor(dense.bias, tp, 0, parts))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(self.tp.copy(x).to(dt), self.weight.to(dt), b)


class RowParallelDense(nn.Module):
    """A ``Dense`` whose input features are this rank's share: the partial
    products are summed by ``tp.reduce`` and the (replicated) bias is added
    once after it. ``weight`` (out, in/tp)."""

    def __init__(self, dense: nn.Module, tp: TensorParallel):
        super().__init__()
        self.dtype, self.tp = dense.dtype, tp
        self.weight = shard_tensor(dense.weight, tp, 1)
        self.bias = dense.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = self.tp.reduce(F.linear(x.to(dt), self.weight.to(dt)))
        return y if self.bias is None else y + self.bias.to(dt)


def tp_modules(model: nn.Module) -> List[nn.Module]:
    """The modules of ``model`` that ``shard_params`` sharded."""
    return [m for m in model.modules()
            if getattr(m, "tp", None) is not None
            and hasattr(m, "tp_shard")]


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Shard ``model`` over the mesh's ``model`` axis, in place, and return
    it: each module with a ``tp_shard`` method (self attention, the MLPs,
    SRA, window attention, DETR's attention and FFN) keeps its rank's heads
    and hidden units. The guard of the JAX function carries over by module:
    a module whose heads (or hidden width) the axis does not divide stays
    replicated, as a leaf that does not divide stays replicated in JAX.
    Without a ``model`` axis, or at size 1, nothing changes (plain DP).
    Call it before building the optimizer: it replaces the parameters."""
    check_mesh(mesh)
    size = mesh.shape.get("model", 1)
    if size == 1:
        return model
    tp = TensorParallel(mesh.group("model"), size, mesh.coordinate("model"))
    for m in list(model.modules()):
        if getattr(m, "tp", None) is None and hasattr(m, "tp_shard") \
                and m.tp_divides(size):
            m.tp_shard(tp)
    return model


@torch.no_grad()
def gather_tensor(t: torch.Tensor, layout) -> torch.Tensor:
    """The whole tensor of a TP shard (every rank's share, in place)."""
    dim, width, parts, group = layout
    n = _group_size(group)
    shards = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(shards, t.contiguous(), group=group)
    shape = list(t.shape)
    shape[dim] = width * parts
    full = t.new_empty(shape)
    for r, s in enumerate(shards):
        full.index_copy_(dim, _share(width, parts, n, r).to(t.device), s)
    return full


def _whole(t: torch.Tensor, p: Optional[torch.Tensor]) -> torch.Tensor:
    layout = getattr(p, "_tp_layout", None)
    return t if layout is None else gather_tensor(t, layout)


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every TP shard gathered whole: the
    state dict of the same model without a mesh (every rank calls it)."""
    params = dict(model.named_parameters())
    return {name: _whole(t, params.get(name))
            for name, t in model.state_dict().items()}


class _WholeModel:
    def __init__(self, state_dict):
        self._state_dict = state_dict

    def state_dict(self):
        return self._state_dict


def gather_train_state(state):
    """A ``TrainState`` of a TP-sharded model as the same run without a
    mesh holds it: the model's state dict and the optimizer's per-leaf
    state gathered whole (what ``utils.checkpoint.save_checkpoint``
    reads). Every rank calls it; rank 0 writes."""
    from types import SimpleNamespace

    opt = state.optimizer
    whole_opt = SimpleNamespace(
        count=opt.count, mini_step=opt.mini_step,
        state={key: [_whole(t, p) for t, p in zip(ts, opt.params)]
               for key, ts in opt.state.items()})
    return SimpleNamespace(model=_WholeModel(gather_state_dict(state.model)),
                           optimizer=whole_opt, step=state.step)


def is_tp_sharded(model: nn.Module) -> bool:
    return bool(tp_modules(model))


def grad_norm_fn(params: Sequence[torch.Tensor]):
    """For a parameter list with TP shards, the function that takes its
    leaves' gradient norms to the whole model's (shards' squared norms
    summed over the axis, replicated leaves counted once); None without
    shards. ``Optimizer.init`` binds it for clipping."""
    layouts = [getattr(p, "_tp_layout", None) for p in params]
    sharded = [layout is not None for layout in layouts]
    if not any(sharded):
        return None
    group = next(layout[3] for layout in layouts if layout is not None)

    def norm(leaf_norms: Sequence[torch.Tensor]) -> torch.Tensor:
        sq = torch.stack([n.float() ** 2 for n in leaf_norms])
        mask = torch.tensor(sharded, device=sq.device)
        part = torch.where(mask, sq, torch.zeros_like(sq)).sum()
        dist.all_reduce(part, group=group)
        return torch.sqrt(part + torch.where(mask, torch.zeros_like(sq),
                                             sq).sum())

    return norm


# ---------------------------------------------------------------- DP helpers


class DataParallel:
    """The batch split over one mesh axis (JAX's ``batch_sharding``).

    ``local(t)``: this rank's rows of a batch every rank holds whole;
    ``gather(t)``: the whole batch's rows from each rank's (the backward
    keeps this rank's rows); ``all_reduce_grads(params)``: sum the
    gradients over the axis in one collective."""

    def __init__(self, mesh: Mesh, axis: str = "data"):
        check_mesh(mesh)
        if axis not in mesh.shape:
            raise ValueError(f"mesh {mesh.shape} has no {axis!r} axis")
        self.mesh, self.axis = mesh, axis
        self.size = mesh.shape[axis]
        self.rank = mesh.coordinate(axis)
        self.group = mesh.group(axis)

    def divides(self, n: int) -> bool:
        return n % self.size == 0

    def local(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        per = t.shape[dim] // self.size
        return t.narrow(dim, self.rank * per, per)

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return gather_from_group(t, dim, self.group)

    @torch.no_grad()
    def all_reduce_grads(self, params: Iterable[torch.Tensor]) -> None:
        """One all-reduce per gradient dtype: the gradients flattened into
        one buffer (one concatenation), summed, and copied back by one
        multi-tensor copy."""
        from torch._utils import (
            _flatten_dense_tensors,
            _unflatten_dense_tensors,
        )

        by_dtype: Dict[torch.dtype, list] = {}
        for p in params:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for gs in by_dtype.values():
            flat = _flatten_dense_tensors(gs)
            dist.all_reduce(flat, group=self.group)
            torch._foreach_copy_(gs, _unflatten_dense_tensors(flat, gs))

    def seeded(self, generator: Optional[torch.Generator]):
        """A context in which ``generator`` draws this rank's dropout seeds
        (different examples, different masks): one draw of the shared
        stream is folded with the rank, and the shared stream continues
        after it on exit, in step on every rank. At one rank a no-op."""
        return _RankSeeded(generator, self.rank if self.size > 1 else None)


class _RankSeeded:
    def __init__(self, generator, rank):
        self.generator, self.rank = generator, rank

    def __enter__(self):
        if self.generator is None or self.rank is None:
            return self
        base = int(torch.randint(0, 2 ** 62, (), generator=self.generator))
        self._after = self.generator.get_state()
        self.generator.manual_seed(fold_seed(base, self.rank))
        return self

    def __exit__(self, *exc):
        if self.generator is not None and self.rank is not None:
            self.generator.set_state(self._after)
        return False


class Replicated:
    """Whole tensors on every rank (JAX's ``replicated``): ``local`` and
    ``gather`` are the identity."""

    def __init__(self, mesh: Mesh):
        self.mesh = check_mesh(mesh)

    def local(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return t

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return t


def batch_sharding(mesh: Mesh, axis: str = "data") -> DataParallel:
    return DataParallel(mesh, axis)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)
