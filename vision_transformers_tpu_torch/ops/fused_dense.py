"""Fused LayerNorm + Dense (+ GELU).

Counterpart of ``vision_transformers_tpu/ops/fused_dense.py``: the CUDA
kernel in ``csrc/ln_dense.cu`` replaces ``_ln_dense_kernel``. It computes
act((LN(x)·γ + β)·W + b) over the rows of x without writing the normalised
rows to device memory: fp32 row statistics, the normalised rows rounded to
x's dtype, the product accumulated in fp32, the fp32 bias and activation,
one rounding to x's dtype.

Two routes, by a stated rule (``ln_dense_route``): bf16 with D, N and W's
leading stride multiples of 8 runs on the tensor cores
(``ln_dense_mma_kernel``, ``csrc/dense_mma_tile.cuh``, after a short
launch that writes each row's mean and rstd to a scratch of 8 bytes a row);
fp32, and bf16 of any other width, on the CUDA cores (``ln_dense_kernel``,
``csrc/dense_tile.cuh``).

As in the JAX package, ``ln_dense`` is a public op that no model calls (the
JAX package's ``vanilla_vit.py`` imports only ``fused_attention_block``);
its gradient is autograd of the plain version, recomputed, as the JAX
package's backward is a jnp recompute (fused_dense.py:162-174). The
wrapper takes the plain version (``ln_dense_reference``) only for a tensor
on the CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vision_transformers_tpu_torch.ops.flash_attention import (
    LAUNCHES,
    _weight_strides,
)

# activation name → the kernel's code (csrc/dense_tile.cuh::Activation)
ACTIVATIONS = {None: 0, "gelu_tanh": 1, "gelu_erf": 2}


def ln_dense_route(dtype: torch.dtype, d: int, n: int, ldk: int,
                   ldn: int) -> str:
    """The route of a CUDA launch: ``"tensor_cores"`` (``ln_stats_kernel``,
    then ``ln_dense_mma_kernel``) for bf16 whose D, N and W's leading stride
    (ldk for the (in, out) layout, ldn = 1; ldn for torch's (out, in) one,
    ldk = 1) are multiples of 8 — the 16-byte rows the tile's copies need,
    every width of the repo — else ``"cuda_cores"`` (``ln_dense_kernel``).
    A shape rule, not a fallback: a launch on the chosen route that fails
    raises."""
    lead = ldk if ldn == 1 else ldn
    if dtype == torch.bfloat16 and d % 8 == 0 and n % 8 == 0 \
            and lead % 8 == 0:
        return "tensor_cores"
    return "cuda_cores"


def _act(y: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    if activation is None:
        return y
    return F.gelu(y, approximate="tanh" if activation == "gelu_tanh"
                  else "none")


def _dims(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
          w: torch.Tensor, bias: Optional[torch.Tensor],
          activation: Optional[str]):
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation: {activation}")
    d = x.shape[-1]
    if w.ndim != 2 or w.shape[0] != d or gamma.numel() != d \
            or beta.numel() != d \
            or (bias is not None and bias.numel() != w.shape[1]):
        raise ValueError(
            f"x (..., {d}) needs gamma and beta of {d}, w ({d}, N) and a bias "
            f"of N; got {tuple(gamma.shape)}, {tuple(beta.shape)}, "
            f"{tuple(w.shape)}, {None if bias is None else tuple(bias.shape)}")
    return d, w.shape[1]


def ln_dense_reference(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, w: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, *,
                       eps: float = 1e-6,
                       activation: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch version (``_ln_dense_ref``, fused_dense.py:135),
    differentiable in x, gamma, beta, w and bias: x (..., D), gamma/beta
    (D,), w (D, N) in x's dtype, bias (N,) or None → (..., N) in x's
    dtype."""
    _dims(x, gamma, beta, w, bias, activation)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    xn = ((xf - mu) * torch.rsqrt(var + eps) * gamma.float()
          + beta.float()).to(x.dtype)
    y = torch.matmul(xn.float(), w.float())
    if bias is not None:
        y = y + bias.float()
    return _act(y, activation).to(x.dtype)


def ln_dense_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 w: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                 eps: float = 1e-6, activation: Optional[str] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward, no autograd graph: one kernel launch on a CUDA x (the
    route of ``ln_dense_route``), the plain version on a CPU one. ``out``
    (CUDA only): a contiguous (..., N) tensor of x's dtype to write into
    instead of a new one. On the tensor-core route x, w, out, gamma and
    beta must be 16-byte aligned, or the launch raises."""
    d, n = _dims(x, gamma, beta, w, bias, activation)
    if x.device.type == "cpu":
        return ln_dense_reference(x, gamma, beta, w, bias, eps=eps,
                                  activation=activation)

    from vision_transformers_tpu_torch.ops import _build

    if not x.is_cuda or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be a float32 or bfloat16 CUDA tensor, got "
                         f"{x.dtype} on {x.device}")
    if w.device != x.device or w.dtype != x.dtype:
        raise ValueError(f"w must be {x.dtype} on {x.device}, got {w.dtype} "
                         f"on {w.device}")
    ldk, ldn = _weight_strides("w", w)
    rows_in = [gamma, beta] + ([] if bias is None else [bias])
    if any(t.device != x.device or t.dtype != torch.float32 for t in rows_in):
        raise ValueError(f"gamma, beta and bias must be fp32 on {x.device}")
    gamma, beta = gamma.reshape(-1).contiguous(), beta.reshape(-1).contiguous()
    bias = None if bias is None else bias.reshape(-1).contiguous()
    x2 = x.reshape(-1, d).contiguous()
    shape = (*x.shape[:-1], n)
    if out is None:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
    elif out.shape != shape or out.dtype != x.dtype \
            or out.device != x.device or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {shape} {x.dtype} tensor "
                         f"on {x.device}")
    lib = _build.load("ln_dense")
    head = (x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
            ldk, ldn, None if bias is None else bias.data_ptr(),
            out.data_ptr())
    tail = (x2.shape[0], d, n, float(eps), ACTIVATIONS[activation])
    with torch.cuda.device(x.device):  # launch on the tensor's card
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if ln_dense_route(x.dtype, d, n, ldk, ldn) == "tensor_cores":
            # each row's (mean, rstd), written by the first of two launches
            stats = torch.empty(x2.shape[0], 2, dtype=torch.float32,
                                device=x.device)
            rc = lib.ln_dense_mma_fwd(*head, stats.data_ptr(), *tail, stream)
        else:
            rc = lib.ln_dense_fwd(*head, *tail,
                                  int(x.dtype == torch.bfloat16), stream)
    _build.check(lib, "ln_dense", rc)
    LAUNCHES["ln_dense"] += 1
    return out


class _LnDense(torch.autograd.Function):
    """``_ln_dense``'s custom_vjp (fused_dense.py:150-177): the forward is
    the kernel, the backward autograd of the plain version, recomputed."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, eps, activation):
        ctx.save_for_backward(x, gamma, beta, w, bias)
        ctx.kw = dict(eps=eps, activation=activation)
        return ln_dense_fwd(x, gamma, beta, w, bias, eps=eps,
                            activation=activation)

    @staticmethod
    def backward(ctx, dy):
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = ln_dense_reference(*inputs, **ctx.kw)
            wanted = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, dy))
        return (*(next(grads) if t is not None and t.requires_grad else None
                  for t in inputs), None, None)


def ln_dense(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             w: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
             eps: float = 1e-6,
             activation: Optional[str] = None) -> torch.Tensor:
    """act((LN(x)·gamma + beta)·w + bias) without the normalised rows in
    device memory. x: (..., D) in the compute dtype; gamma/beta: fp32 (D,);
    w: (D, N) in x's dtype (row-major, or the transpose of torch's (N, D)
    Linear weight); bias: fp32 (N,) or None. activation: None,
    ``"gelu_tanh"`` or ``"gelu_erf"``. Returns (..., N) in x's dtype; LN
    statistics and the product accumulate in fp32. Differentiable in all
    five tensors."""
    return _LnDense.apply(x, gamma, beta, w, bias, float(eps), activation)
