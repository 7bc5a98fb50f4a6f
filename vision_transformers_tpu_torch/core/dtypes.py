"""Dtype and device policy: fp32 params, compute dtype per module.

Counterpart of ``vision_transformers_tpu/core/dtypes.py``. Parameters are
stored in fp32; each module casts them to its compute dtype at call time
(bf16 on the card, fp32 for the CPU reference runs). Softmax and
normalisation statistics stay fp32 inside the ops.

``Policy`` and ``default_policy`` are the JAX module's mixed-precision
policy: fp32 master weights, bf16 compute on the accelerator (here a CUDA
device), fp32 compute on the CPU.

``resolve_device`` is the one place that turns a ``device`` argument into a
``torch.device``: the default is CUDA, and asking for CUDA where there is
none raises, so an entry point never carries on quietly on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Union

import torch

DeviceLike = Union[str, torch.device, None]
DtypeLike = Union[str, torch.dtype]


PARAM_DTYPE = torch.float32  # master weights, whatever the compute dtype


@dataclasses.dataclass(frozen=True)
class Policy:
    """Mixed-precision policy: the master weights' dtype and the matmul and
    activation dtype. Softmax and normalisation statistics accumulate in
    fp32 inside the ops whatever the policy."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    def cast_to_compute(self, tree: Any) -> Any:
        """``tree`` (tensors in dicts, lists and tuples) with every
        floating tensor cast to ``compute_dtype``; other leaves as they
        are."""
        if isinstance(tree, torch.Tensor):
            return (tree.to(self.compute_dtype) if tree.is_floating_point()
                    else tree)
        if isinstance(tree, dict):
            return {k: self.cast_to_compute(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.cast_to_compute(v) for v in tree)
        return tree


def default_policy() -> Policy:
    """bf16 compute where a CUDA device is present; fp32 everywhere on the
    CPU (the reference runs of the tests)."""
    if torch.cuda.is_available():
        return Policy()
    return Policy(compute_dtype=torch.float32)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA is
    asked for (explicitly or by default) and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


def as_dtype(dtype: DtypeLike) -> torch.dtype:
    """``torch.bfloat16`` or its name (``"bfloat16"``) → ``torch.bfloat16``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"not a torch dtype: {dtype!r}")
    return out


def dtype_name(dtype: DtypeLike) -> str:
    """``torch.bfloat16`` → ``"bfloat16"`` (for manifests and configs)."""
    return str(as_dtype(dtype)).removeprefix("torch.")
