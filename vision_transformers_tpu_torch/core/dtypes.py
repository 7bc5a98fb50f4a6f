"""Dtype and device policy: fp32 params, compute dtype per module.

Counterpart of ``vision_transformers_tpu/core/dtypes.py``. Parameters are
stored in fp32; each module casts them to its compute dtype at call time
(bf16 on the card, fp32 for the CPU reference runs). Softmax and
normalisation statistics stay fp32 inside the ops.

``resolve_device`` is the one place that turns a ``device`` argument into a
``torch.device``: the default is CUDA, and asking for CUDA where there is
none raises, so an entry point never carries on quietly on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]
DtypeLike = Union[str, torch.dtype]


PARAM_DTYPE = torch.float32  # master weights, whatever the compute dtype


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
