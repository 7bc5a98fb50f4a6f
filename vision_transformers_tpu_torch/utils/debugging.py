"""Numeric sanitization hooks.

Counterpart of ``vision_transformers_tpu/utils/debugging.py``. PyTorch's
idiom for JAX's NaN debugger is autograd anomaly detection, and for
checkify a wrapper that checks what a function returns:

- ``enable_nan_checks`` / ``nan_checks`` turn on
  ``torch.autograd.set_detect_anomaly(True, check_nan=True)``: a backward
  that produces a NaN raises, naming the forward operation whose gradient
  it was (with its forward traceback). Unlike ``jax_debug_nans`` it does
  not look at forward values, and it slows the backward down.
- ``checked(fn)`` returns a function that runs ``fn`` and raises
  ``FloatingPointError`` when a floating-point tensor in its output holds a
  NaN or an infinity. JAX's checkify also instruments the operations inside
  ``fn`` (division by zero, out-of-bounds indexing, NaNs of intermediates)
  and returns the error instead of raising; here only the outputs are
  checked (an out-of-bounds index already raises in PyTorch, and a CUDA
  kernel's fault surfaces at the next synchronisation).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch


def enable_nan_checks(enabled: bool = True) -> None:
    """Anomaly detection for every backward from now on (or off)."""
    torch.autograd.set_detect_anomaly(enabled, check_nan=True)


@contextlib.contextmanager
def nan_checks():
    """Anomaly detection inside the block, restored after it."""
    with torch.autograd.detect_anomaly(check_nan=True):
        yield


def _non_finite(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_floating_point() and not bool(torch.isfinite(out).all())
    if isinstance(out, (tuple, list)):
        return any(_non_finite(o) for o in out)
    if isinstance(out, dict):
        return any(_non_finite(o) for o in out.values())
    return False


def checked(fn: Callable) -> Callable:
    """``fn`` that raises ``FloatingPointError`` on a non-finite float in
    its output (tensors, and tuples, lists and dicts of them). The check
    synchronises with the device."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        if _non_finite(out):
            raise FloatingPointError(
                f"{getattr(fn, '__name__', fn)!s} returned a NaN or an "
                "infinity")
        return out

    return wrapper
