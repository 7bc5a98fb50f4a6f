"""Adam/AdamW update in one memory pass over all the leaves of a step, in
place.

Counterpart of ``vision_transformers_tpu/ops/fused_adam.py``: the CUDA kernel
in ``csrc/fused_adam.cu`` replaces ``_adam_kernel``. It reads (p, m, v, g)
once, computes the whole Adam(+decoupled weight decay) update in fp32 and
writes (p', m', v') once over the same memory: 7 streams of 4 bytes per
element. The JAX function returns new trees (its kernel aliases inputs to
outputs); here the tensors the caller holds are updated in place.

The arithmetic is the TPU kernel's (``optax.adam``/``adamw`` with the bias
corrections folded into two scalars computed on the host per step):

    m' = b1·m + (1 − b1)·g            v' = b2·v + (1 − b2)·g²
    p' = p − lr·((m'·c1)/(√(v'·c2) + eps) + wd·p),   c = 1/(1 − bᵗ)

which multiplies by c1 where ``training.optimizers``' unfused Adam (and
optax) divides by 1 − b1ᵗ: the two differ in the last bit.

On CUDA every fp32 leaf of a card goes through the kernel, small ones too,
in one launch per step (one more per ``_TABLE_LEAVES`` leaves past the
first): the JAX package keeps leaves under ``_MIN_FUSED_SIZE`` elements on
jnp math because a launch per leaf would cost more than their bytes, and one
launch for all of them removes that cost. ``FusedAdamLeaves`` checks the p,
m and v lists once and keeps the pointer table the C entry reads; a step
checks the gradients, fills in their pointers and makes one C call. On the
CPU the split of the JAX package stays: fp32 leaves of at least
``_MIN_FUSED_SIZE`` elements take the kernel's plain version, smaller fp32
ones the same arithmetic through ``torch._foreach_*``. Leaves of another
dtype take ``fused_adam_reference`` on either device, keeping their dtype.
The routes are by device, size and dtype, never by a failure: on a CUDA
tensor the kernel launches or the call raises. ``fused_adam_reference`` is
the kernel's plain version and what the kernel is held against.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from vision_transformers_tpu_torch.ops.flash_attention import LAUNCHES

# the JAX package's threshold of its kernel, kept for the CPU route
_MIN_FUSED_SIZE = 65536
_TABLE_LEAVES = 320  # leaves of one launch: csrc/adam_plan.cuh's kMaxLeaves


class AdamScalars(NamedTuple):
    """The kernel's seven fp32 scalars, as Python floats holding fp32
    values (``_adam_kernel``'s ``sc_ref``)."""

    b1: float
    b2: float
    c1: float
    c2: float
    neg_lr: float
    wd: float
    eps: float


def adam_scalars(count_inc: int, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0) -> AdamScalars:
    """``count_inc`` is the 1-based step number. Everything is rounded to
    fp32 and the bias corrections are computed in fp32, as the JAX function
    computes them (fused_adam.py:122-129)."""
    f = np.float32
    t = f(count_inc)
    one = f(1)
    return AdamScalars(
        float(f(b1)), float(f(b2)),
        float(one / (one - np.power(f(b1), t))),
        float(one / (one - np.power(f(b2), t))),
        float(-f(lr)), float(f(weight_decay)), float(f(eps)))


def _one_minus(b: float) -> float:
    """1 − b in fp32, as the kernel computes it."""
    return float(np.float32(1) - np.float32(b))


@torch.no_grad()
def fused_adam_reference(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                         g: torch.Tensor, s: AdamScalars) -> None:
    """Plain PyTorch version of the kernel, and ``_jnp_leaf``
    (fused_adam.py:101-111): the same operations in the same order, each
    rounded to fp32 on its own; p, m and v are overwritten and keep their
    dtypes."""
    g32, p32 = g.float(), p.float()
    m32 = s.b1 * m.float() + _one_minus(s.b1) * g32
    v32 = s.b2 * v.float() + _one_minus(s.b2) * (g32 * g32)
    upd = (m32 * s.c1) / (torch.sqrt(v32 * s.c2) + s.eps) + s.wd * p32
    p.copy_(p32 + s.neg_lr * upd)
    m.copy_(m32)
    v.copy_(v32)


def _small_leaves(ps, ms, vs, gs, s: AdamScalars) -> None:
    """The reference's arithmetic over many small fp32 leaves at once: a
    dozen launches for all of them instead of a dozen each."""
    torch._foreach_mul_(ms, s.b1)
    torch._foreach_add_(ms, torch._foreach_mul(gs, _one_minus(s.b1)))
    torch._foreach_mul_(vs, s.b2)
    g2 = torch._foreach_mul(gs, gs)
    torch._foreach_mul_(g2, _one_minus(s.b2))
    torch._foreach_add_(vs, g2)
    denom = torch._foreach_mul(vs, s.c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, s.eps)
    upd = torch._foreach_mul(ms, s.c1)
    torch._foreach_div_(upd, denom)
    torch._foreach_add_(upd, torch._foreach_mul(ps, s.wd))
    torch._foreach_mul_(upd, s.neg_lr)
    torch._foreach_add_(ps, upd)


def adam_route(device_type: str, dtype: torch.dtype, numel: int) -> str:
    """The route of a parameter leaf: ``"kernel"`` (every non-empty fp32 leaf
    on CUDA, in the step's one launch), ``"foreach"`` (fp32 leaves under
    ``_MIN_FUSED_SIZE`` elements on the CPU, the reference's arithmetic over
    all of them at once, if its moments and gradient are fp32 too) or
    ``"reference"`` (``fused_adam_reference``: large fp32 leaves on the CPU,
    the kernel's plain version, and leaves of any other dtype)."""
    if dtype != torch.float32:
        return "reference"
    if device_type == "cuda":
        return "kernel" if numel else "reference"
    return "foreach" if numel < _MIN_FUSED_SIZE else "reference"


class _CardLeaves:
    """The fp32 leaves of one card, checked once: the (L, 5) int64 table of
    (p, m, v, g, n) that the C entry ``adam_multi`` reads, each step's g
    filled in by ``launch``."""

    def __init__(self, device: torch.device, leaves):
        self.device = device
        self.shapes = []
        self.table = np.zeros((len(leaves), 5), np.int64)
        for row, (p, m, v) in zip(self.table, leaves):
            for name, t in zip("pmv", (p, m, v)):
                if not t.is_cuda or t.device != device \
                        or t.dtype != torch.float32 or not t.is_contiguous() \
                        or t.shape != p.shape:
                    raise ValueError(
                        f"fused_adam: {name} must be a contiguous fp32 CUDA "
                        f"tensor of shape {tuple(p.shape)} on {device}; "
                        f"got {t.dtype} {tuple(t.shape)} on {t.device}")
            row[:3] = [p.data_ptr(), m.data_ptr(), v.data_ptr()]
            row[4] = p.numel()
            self.shapes.append(p.shape)
        self.launches = -(-len(leaves) // _TABLE_LEAVES)

    def launch(self, grads, s: AdamScalars) -> None:
        from vision_transformers_tpu_torch.ops import _build

        ptrs, keep = [], []
        for g, shape in zip(grads, self.shapes):
            if g.dtype != torch.float32 or g.device != self.device \
                    or g.shape != shape:
                raise ValueError(
                    f"fused_adam: a gradient must be an fp32 tensor of shape "
                    f"{tuple(shape)} on {self.device}; got {g.dtype} "
                    f"{tuple(g.shape)} on {g.device}")
            if not g.is_contiguous():
                g = g.contiguous()
                keep.append(g)  # alive until the launch is queued
            ptrs.append(g.data_ptr())
        self.table[:, 3] = ptrs
        lib = _build.load("fused_adam")
        with torch.cuda.device(self.device):  # launch on the tensors' card
            rc = lib.adam_multi(
                self.table.ctypes.data, len(self.shapes), *s,
                torch.cuda.current_stream(self.device).cuda_stream)
        _build.check(lib, "fused_adam", rc)
        LAUNCHES["fused_adam"] += self.launches


class FusedAdamLeaves:
    """Lists of parameters and their fp32 moments, sorted once into their
    routes (the module's docstring) and checked once; ``update`` then takes
    one Adam(W) step in place from a list of gradients. The optimizer of
    ``training.optimizers`` binds one at ``init``."""

    def __init__(self, params: Sequence[torch.Tensor],
                 mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor]):
        self.params, self.mu, self.nu = params, mu, nu
        self.cards = []  # (_CardLeaves, leaf indices)
        self.routes = {"foreach": [], "reference": []}
        by_card = {}
        for i, p in enumerate(params):
            route = adam_route(p.device.type, p.dtype, p.numel())
            if route == "kernel":
                by_card.setdefault(p.device, []).append(i)
            else:
                self.routes[route].append(i)
        for device, idx in by_card.items():
            self.cards.append((_CardLeaves(
                device, [(params[i], mu[i], nu[i]) for i in idx]), idx))

    def _leaf(self, i, grads):
        return self.params[i], self.mu[i], self.nu[i], grads[i]

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], count_inc: int,
               lr: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, weight_decay: float = 0.0) -> None:
        """One Adam(W) step: ``count_inc`` the 1-based step number, ``lr``
        this step's learning rate (a schedule's value)."""
        s = adam_scalars(count_inc, lr, b1, b2, eps, weight_decay)
        if len(grads) != len(self.params):
            raise ValueError(f"fused_adam: {len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        for card, idx in self.cards:
            card.launch([grads[i] for i in idx], s)
        small = ([], [], [], [])
        for i in self.routes["foreach"]:
            leaf = self._leaf(i, grads)
            if all(t.dtype == torch.float32 for t in leaf):
                for group, t in zip(small, leaf):
                    group.append(t)
            else:
                fused_adam_reference(*leaf, s)
        for i in self.routes["reference"]:
            fused_adam_reference(*self._leaf(i, grads), s)
        if small[0]:
            _small_leaves(*small, s)


def fused_adam_update(params: Sequence[torch.Tensor],
                      mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                      grads: Sequence[torch.Tensor], count_inc: int,
                      lr: float, b1: float = 0.9, b2: float = 0.999,
                      eps: float = 1e-8, weight_decay: float = 0.0
                      ) -> Tuple[Sequence[torch.Tensor], ...]:
    """One Adam(W) step over lists of leaves, in place; returns
    (params, mu, nu), the very lists it was given. The lists are checked on
    every call: a caller that steps the same lists again binds them once
    with ``FusedAdamLeaves``."""
    FusedAdamLeaves(params, mu, nu).update(grads, count_inc, lr, b1, b2, eps,
                                           weight_decay)
    return params, mu, nu
