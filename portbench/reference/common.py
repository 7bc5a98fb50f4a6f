"""Plain fp32 building blocks of the reference models.

Nothing here imports the program under test: these are the published
equations written out in plain PyTorch, run in float32 with TF32 off. The
reference reads only the weights and inputs that the benchmark made from its
seed, and redraws the program's random choices (stochastic depth) from the
same host seeds by the rule copied below.

``Quant`` is the precision of the matrix products: ``Quant.none`` keeps
float32; ``Quant.fp8`` rounds both operands of every product to float8
e4m3 with one scale per tensor, and their gradients to e5m2: the control
that a bfloat16 program has to beat.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    """float32 products in float32: the card would take TF32 otherwise."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to the float8 ``dtype`` with one scale per tensor that
    puts its largest magnitude at the format's largest."""
    amax = t.abs().amax().clamp_min(1e-30)
    scale = torch.finfo(dtype).max / amax
    return (t * scale).to(dtype).float() / scale


class _RoundFp8(torch.autograd.Function):
    """Operands in e4m3 forward and their gradients in e5m2 backward, the
    formats of float8 training; the rounding itself passes the gradient."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _fp8(grad, torch.float8_e5m2)


class Quant:
    """Rounding applied to the operands of each product."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return _RoundFp8.apply(t) if self.fp8 else t


Quant.none = Quant(False)
Quant.fp8 = Quant(True)


def linear(x: torch.Tensor, w: torch.Tensor, b, q: Quant) -> torch.Tensor:
    """x·wᵀ + b, w in torch's (out, in) layout."""
    y = torch.matmul(q(x), q(w).t())
    return y if b is None else y + b


def matmul(a: torch.Tensor, b: torch.Tensor, q: Quant) -> torch.Tensor:
    return torch.matmul(q(a), q(b))


def layer_norm(x, w, b, eps: float) -> torch.Tensor:
    return F.layer_norm(x, w.shape, w, b, eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU as published (the erf form)."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def attention(q, k, v, scale: float, bias, quant: Quant) -> torch.Tensor:
    """softmax(q·kᵀ·scale + bias)·v on (G, H, N, dh)."""
    s = matmul(q, k.transpose(-1, -2), quant) * scale
    if bias is not None:
        s = s + bias
    return matmul(torch.softmax(s, dim=-1), v, quant)


def patchify(images: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, C) → (B, H/p · W/p, p·p·C), each patch's features ordered
    (row, column, channel): a stride-p p×p convolution as a product."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def normalize(images_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 NHWC → float32, scaled to [0, 1], then (x − mean) / std."""
    x = images_u8.float() / 255.0
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def cross_entropy(logits, labels, weights) -> torch.Tensor:
    """Weighted mean of the per-image cross-entropy."""
    per = torch.logsumexp(logits, dim=-1) - logits.gather(
        1, labels[:, None])[:, 0]
    return (per * weights).sum() / weights.sum().clamp_min(1.0)


# -- the program's random choices, redrawn by a frozen copy of its rule ----

def block_seeds(generator: torch.Generator, count: int) -> List[int]:
    """One forward's block seeds: ``count`` integers below 2**62 drawn on the
    host from the model's dropout generator."""
    return torch.randint(0, 2 ** 62, (count,), generator=generator).tolist()


def drop_path(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Per-image stochastic depth: keep the branch with probability
    1 − rate, from a generator on x's device seeded with ``seed``, and
    scale survivors by 1 / (1 − rate)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    mask = torch.rand(shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


# -- AdamW, decoupled weight decay, as published (arXiv:1711.05101) --------

class AdamW:
    """Plain AdamW over a dict of float32 leaves (every leaf decays)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = params
        self.lr, self.wd, self.b1, self.b2, self.eps = (
            lr, weight_decay, b1, b2, eps)
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        t = self.count
        c1 = 1.0 - self.b1 ** t
        c2 = 1.0 - self.b2 ** t
        for k, p in self.params.items():
            g = grads[k]
            m = self.mu[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v = self.nu[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            update = (m / c1) / ((v / c2).sqrt() + self.eps)
            p.sub_(self.lr * (update + self.wd * p))
