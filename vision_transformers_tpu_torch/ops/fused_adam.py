"""Adam/AdamW update as one memory pass per parameter leaf, in place.

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

As in the JAX package, fp32 leaves of at least ``_MIN_FUSED_SIZE`` elements
take the kernel, one launch per leaf; smaller leaves and leaves of another
dtype take the same arithmetic in plain PyTorch, keeping their dtype (the
small fp32 ones together, through ``torch._foreach_*``). That split is by
size and dtype, never by a failure: on a CUDA tensor the kernel launches or
the call raises. ``fused_adam_reference`` is the kernel's plain version: it
serves large leaves on the CPU and is what the kernel is held against.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from vision_transformers_tpu_torch.ops.flash_attention import LAUNCHES

_MIN_FUSED_SIZE = 65536
# grid of the streaming kernel: blocks of 256 threads, a few per SM
_BLOCKS = 132 * 8


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


def _launch(leaves, s: AdamScalars) -> None:
    """One kernel launch per (p, m, v, g) of ``leaves``, all on one card. The
    library, the stream and the device guard are looked up once for the
    lot: with one launch per leaf, what the host spends per launch is what
    the step costs."""
    from vision_transformers_tpu_torch.ops import _build

    device = leaves[0][0].device
    for leaf in leaves:
        for name, t in zip("pmvg", leaf):
            if not t.is_cuda or t.device != device \
                    or t.dtype != torch.float32 or not t.is_contiguous() \
                    or t.shape != leaf[0].shape:
                raise ValueError(
                    f"fused_adam: {name} must be a contiguous fp32 CUDA "
                    f"tensor of shape {tuple(leaf[0].shape)} on {device}; "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    lib = _build.load("fused_adam")
    with torch.cuda.device(device):  # launch on the tensors' card
        stream = torch.cuda.current_stream(device).cuda_stream
        for p, m, v, g in leaves:
            rc = lib.fused_adam(p.data_ptr(), m.data_ptr(), v.data_ptr(),
                                g.data_ptr(), p.numel(), *s, _BLOCKS, stream)
            _build.check(lib, "fused_adam", rc)
            LAUNCHES["fused_adam"] += 1


@torch.no_grad()
def fused_adam_update(params: Sequence[torch.Tensor],
                      mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                      grads: Sequence[torch.Tensor], count_inc: int,
                      lr: float, b1: float = 0.9, b2: float = 0.999,
                      eps: float = 1e-8, weight_decay: float = 0.0
                      ) -> Tuple[Sequence[torch.Tensor], ...]:
    """One Adam(W) step over lists of leaves, in place; returns
    (params, mu, nu), the very lists it was given.

    ``count_inc``: the 1-based step number; ``lr``: this step's learning
    rate (a schedule's value). fp32 leaves of at least 65 536 elements go
    through the kernel (their plain version on the CPU), the rest through
    the same arithmetic in plain PyTorch."""
    s = adam_scalars(count_inc, lr, b1, b2, eps, weight_decay)
    small = ([], [], [], [])
    large = {}  # device -> leaves for the kernel
    for p, m, v, g in zip(params, mu, nu, grads):
        leaf = (p, m, v, g)
        if p.numel() >= _MIN_FUSED_SIZE and p.dtype == torch.float32:
            if p.is_cuda:
                large.setdefault(p.device, []).append(
                    (p, m, v, g.contiguous()))
            else:
                fused_adam_reference(p, m, v, g, s)
        elif all(t.dtype == torch.float32 for t in leaf):
            for group, t in zip(small, leaf):
                group.append(t)
        else:
            fused_adam_reference(p, m, v, g, s)
    for leaves in large.values():
        _launch(leaves, s)
    if small[0]:
        _small_leaves(*small, s)
    return params, mu, nu
