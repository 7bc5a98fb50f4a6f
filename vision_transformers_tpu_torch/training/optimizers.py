"""Optimizer zoo.

Counterpart of ``vision_transformers_tpu/training/optimizers.py``: the same
``make_optimizer`` surface (adam, adamw, sgd, rmsprop; weight decay, gradient
clipping, a schedule, gradient accumulation) with the update rules of the
optax transformations that file chains, so that a trajectory in the port
follows the JAX package's step for step. Where optax and ``torch.optim``
differ, optax's arithmetic is kept:

- ``adam`` with ``weight_decay`` is decoupled AdamW, not an L2 term;
- ``rmsprop`` decays its second moment by 0.9, takes eps inside the square
  root, and applies momentum after the learning rate;
- clipping scales by max_norm / norm only when norm >= max_norm;
- accumulation applies the running mean gradient on every k-th step, and
  clipping acts on that mean, not on each gradient that enters it;
- a schedule is read at the count of updates already applied.

The updates run in place on fp32 parameters through ``torch._foreach_*``
(a handful of launches per step, whatever the number of parameters). The JAX
package's opt-in single-pass Adam kernel (``fused=True``) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Union

import numpy as np
import torch

Schedule = Callable[[int], float]


class Optimizer:
    """What ``make_optimizer`` returns: hyper-parameters first, parameters
    bound later (as an optax transformation is made before its state).

        tx = make_optimizer("adam", 1e-3).init(model.parameters())
        loss.backward(); tx.step(); tx.zero_grad()

    ``count`` is the number of updates applied (accumulation steps that
    only gather a gradient do not count)."""

    def __init__(self, name: str, learning_rate: Union[float, Schedule], *,
                 weight_decay: float, momentum: Optional[float],
                 grad_clip_norm: Optional[float], accumulate_steps: int):
        if name not in ("adam", "adamw", "sgd", "rmsprop"):
            raise ValueError(f"Unknown optimizer: {name}")
        self.name = name
        self.learning_rate = learning_rate
        self.weight_decay = float(weight_decay)
        self.momentum = momentum
        self.grad_clip_norm = grad_clip_norm
        self.accumulate_steps = max(1, int(accumulate_steps))
        self.params: List[torch.Tensor] = []
        self.count = 0
        self.mini_step = 0
        self.state: dict = {}

    def init(self, params: Iterable[torch.Tensor]) -> "Optimizer":
        """Bind the parameters and zero the state."""
        self.params = [p for p in params if p.requires_grad]
        self.count = 0
        self.mini_step = 0
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        self.state = {}
        if self.name in ("adam", "adamw"):
            self.state = {"mu": zeros(), "nu": zeros()}
        elif self.name == "sgd" and self.momentum is not None:
            self.state = {"trace": zeros()}
        elif self.name == "rmsprop":
            self.state = {"nu": zeros()}
            if self.momentum is not None:
                self.state["trace"] = zeros()
        if self.accumulate_steps > 1:
            self.state["acc"] = zeros()
        return self

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def step(self) -> None:
        """One optimizer step from the parameters' ``.grad``."""
        params = self.params
        if not params:
            raise RuntimeError("call init(params) before step()")
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        if self.accumulate_steps > 1:
            acc = self.state["acc"]
            # running mean: acc += (g - acc) / (n + 1)
            diff = torch._foreach_sub(grads, acc)
            torch._foreach_add_(acc, diff, alpha=1.0 / (self.mini_step + 1))
            if self.mini_step != self.accumulate_steps - 1:
                self.mini_step += 1
                return
            grads = acc
        if self.grad_clip_norm is not None:  # of the mean gradient
            grads = self._clip(grads)
        lr = self.lr_at(self.count)
        getattr(self, f"_{self.name}")(params, grads, lr)
        self.count += 1
        if self.accumulate_steps > 1:
            torch._foreach_zero_(self.state["acc"])
            self.mini_step = 0

    def _clip(self, grads):
        norms = torch._foreach_norm(grads)
        g_norm = torch.linalg.vector_norm(torch.stack(norms))
        max_norm = float(self.grad_clip_norm)
        factor = torch.where(g_norm < max_norm, torch.ones_like(g_norm),
                             max_norm / g_norm)
        return torch._foreach_mul(grads, factor)

    def _adam(self, params, grads, lr, b1=0.9, b2=0.999, eps=1e-8):
        mu, nu = self.state["mu"], self.state["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        # bias corrections in fp32, as optax computes them: 1 - b**t loses
        # digits there (1 - 0.999 is exact to 5e-5 only), and a trajectory
        # that is to follow optax's has to lose the same ones
        t = np.float32(self.count + 1)
        c1 = float(np.float32(1) - np.float32(b1) ** t)
        c2 = float(np.float32(1) - np.float32(b2) ** t)
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        update = torch._foreach_div(mu, c1)
        torch._foreach_div_(update, denom)
        if self.weight_decay:
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_add_(params, update, alpha=-lr)

    _adamw = _adam

    def _sgd(self, params, grads, lr):
        update = grads
        if self.momentum is not None:
            trace = self.state["trace"]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, grads)
            update = trace
        torch._foreach_add_(params, update, alpha=-lr)

    def _rmsprop(self, params, grads, lr, decay=0.9, eps=1e-8):
        nu = self.state["nu"]
        torch._foreach_mul_(nu, decay)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - decay)
        denom = torch._foreach_add(nu, eps)  # eps inside the square root
        torch._foreach_sqrt_(denom)
        update = torch._foreach_div(grads, denom)
        torch._foreach_mul_(update, -lr)
        if self.momentum is not None:  # momentum after the learning rate
            trace = self.state["trace"]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, update)
            update = trace
        torch._foreach_add_(params, update)


def make_optimizer(
    name: str = "adam",
    lr: float = 1e-4,
    *,
    weight_decay: float = 0.0,
    momentum: float = 0.9,
    grad_clip_norm: Optional[float] = None,
    schedule: Optional[Schedule] = None,
    accumulate_steps: int = 1,
    fused: Optional[bool] = None,
) -> Optimizer:
    """The JAX package's factory. ``weight_decay`` applies to adam and adamw
    (decoupled), ``momentum`` to sgd and rmsprop. ``schedule`` (count → lr)
    replaces ``lr``. Bind parameters with ``.init(params)``."""
    name = name.lower()
    if fused:
        raise NotImplementedError(
            "the single-pass Adam kernel is not ported yet "
            "(ROADMAP.md, queue 2, row 15)")
    return Optimizer(
        name, schedule if schedule is not None else lr,
        weight_decay=weight_decay if name in ("adam", "adamw") else 0.0,
        momentum=momentum if name in ("sgd", "rmsprop") else None,
        grad_clip_norm=grad_clip_norm, accumulate_steps=accumulate_steps)


def cosine_schedule(base_lr: float, total_steps: int,
                    warmup_steps: int = 0) -> Schedule:
    """Linear warm-up from 0 to ``base_lr`` over max(warmup_steps, 1) steps,
    then a cosine decay to 0 that ends at max(total_steps, warmup_steps + 1)
    (optax's ``warmup_cosine_decay_schedule`` with these arguments)."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1) - warmup
    if decay <= 0:
        raise ValueError(
            "the cosine decay needs at least one step after the warm-up: "
            f"total_steps={total_steps}, warmup_steps={warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup:
            return base_lr * count / warmup
        frac = min(count - warmup, decay) / decay
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * frac))

    return schedule
