"""int8 (w8a8) quantized Dense for serving.

Counterpart of ``vision_transformers_tpu/ops/quant.py``:

- ``QuantDense``: drop-in for ``Dense`` holding ``kernel_q`` (int8,
  per-output-channel symmetric), ``kernel_scale`` (fp32) and ``bias``
  (fp32). Activations are quantized dynamically per row (abs-max over the
  contraction dim), so no calibration data is needed.
- ``quantize_dense_params``: a trained ``Dense``'s weights → the
  ``QuantDense`` state.

The product accumulates int8 × int8 in int32 and the (row scale × channel
scale) rescale is a rank-1 outer product applied to the int32 result: exact,
with no error beyond the two input roundings. The JAX package computes the
product with ``lax.dot_general`` outside any Pallas kernel; here it is
``torch._int_mm`` on either device (exact in int32, so the CPU gives the
card's bits). Layouts are torch's: ``kernel_q`` is (out, in), the transpose
of the JAX tree's (in, out).

On CUDA ``torch._int_mm`` takes more than 16 rows and K and N multiples of
8. Fewer rows are padded with zero rows, which quantize to exactly 0 and are
sliced off; a K or N off the multiple raises ``ValueError``. Nothing is
computed in float instead.

``PRODUCTS["int8_matmul"]`` counts the int8 products run (either device);
``reset_product_counts()`` zeroes it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vision_transformers_tpu_torch.ops.layers import Dense

PRODUCTS = {"int8_matmul": 0}
_CUDA_MIN_ROWS = 17  # torch._int_mm on CUDA: more than 16 rows


def reset_product_counts() -> None:
    PRODUCTS["int8_matmul"] = 0


_DIVISOR = {}  # device → the 0-dim tensor 127.0 on it


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    """max(absmax, 1e-12) / 127 in fp32, a true division on every device:
    CUDA divides by a Python scalar as a product with its reciprocal, one
    ulp off the quotient JAX and the CPU compute, so the divisor is a
    tensor on absmax's device (made once per device)."""
    div = _DIVISOR.get(absmax.device)
    if div is None:
        div = _DIVISOR[absmax.device] = torch.full((), 127.0,
                                                   device=absmax.device)
    return torch.clamp(absmax, min=1e-12) / div


def dynamic_quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization over the last dim.

    Returns (x_q int8, scale fp32 with a trailing keepdim). Zero rows get
    scale 1e-12 / 127 and quantize to 0 exactly."""
    xf = x.float()
    scale = _scale(xf.abs().amax(dim=-1, keepdim=True))
    xq = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return xq, scale


def quantize_kernel(weight: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 weights: (out, in) float → int8.

    Returns (kernel_q int8 (out, in), kernel_scale fp32 (out,)); the JAX
    function takes and returns the (in, out) transpose."""
    wf = weight.detach().float()
    scale = _scale(wf.abs().amax(dim=1))
    kq = torch.clamp(torch.round(wf / scale[:, None]), -127, 127).to(
        torch.int8)
    return kq, scale


def quantize_dense_params(dense: Dense) -> dict:
    """A ``Dense``'s weight [and bias] → the ``QuantDense`` state
    {kernel_q, kernel_scale[, bias]}."""
    kq, scale = quantize_kernel(dense.weight)
    out = {"kernel_q": kq, "kernel_scale": scale}
    if dense.bias is not None:
        out["bias"] = dense.bias.detach().float().clone()
    return out


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 × (K, N) int8 → (M, N) int32 by ``torch._int_mm``,
    within its CUDA shape rules (the module's docstring)."""
    m, k = a.shape
    n = b.shape[1]
    if a.is_cuda:
        if k % 8 or n % 8:
            raise ValueError(
                f"int8_matmul on CUDA: torch._int_mm needs K and N multiples "
                f"of 8, got K {k}, N {n}")
        if m < _CUDA_MIN_ROWS:
            a = torch.cat([a, a.new_zeros(_CUDA_MIN_ROWS - m, k)])
            return torch._int_mm(a, b)[:m]
    return torch._int_mm(a, b)


def int8_matmul(x: torch.Tensor, kernel_q: torch.Tensor,
                kernel_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(..., in) float × (out, in) int8 → (..., out) float.

    Dynamic per-row activation quantization, int32 accumulation, the exact
    rank-1 rescale, then the bias, then the cast to ``out_dtype`` (default:
    x's dtype), in that order (JAX ``int8_matmul``)."""
    out_dtype = out_dtype or x.dtype
    xq, x_scale = dynamic_quant_rows(x)
    acc = _int_mm(xq.reshape(-1, xq.shape[-1]), kernel_q.t())
    PRODUCTS["int8_matmul"] += 1
    acc = acc.reshape(*x.shape[:-1], kernel_q.shape[0])
    y = acc.float() * (x_scale * kernel_scale.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


class QuantDense(nn.Module):
    """int8 w8a8 Dense for serving. Its state mirrors the JAX tree:
    ``kernel_q`` (int8, (out, in)), ``kernel_scale`` (fp32) and ``bias``
    (fp32, optional), buffers built as zeros, ones and zeros (the JAX
    module's init) and filled from a trained ``Dense`` by
    ``quantize_dense_params``. ``dtype`` is the output dtype. A module-wide
    ``.to(dtype)`` casts floating tensors only, so it never reaches
    ``kernel_q``; the rescale reads the scale and bias in fp32."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("kernel_q", torch.zeros(
            out_features, in_features, dtype=torch.int8))
        self.register_buffer("kernel_scale", torch.ones(out_features))
        self.register_buffer(
            "bias", torch.zeros(out_features) if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_matmul(x, self.kernel_q, self.kernel_scale, self.bias,
                           out_dtype=self.dtype)
