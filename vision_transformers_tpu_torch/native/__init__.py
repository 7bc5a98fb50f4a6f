"""Native (C++) host-runtime components.

Counterpart of ``vision_transformers_tpu/native/__init__.py``: the fused
augmentation loop of the training input pipeline (``augment.cpp``, this
package's own copy), compiled with ``g++`` at first use and bound through
``ctypes``. The library goes to ``csrc/build/`` beside the CUDA kernels
(listed in ``.gitignore``), named by a hash of the source and the flags, so
an edited source builds anew. Every native entry point has a numpy fallback
in ``utils/load_data.py``; ``available()`` reports which path is live.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "augment.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "csrc" / "build"
# no -march=native: the build directory travels with a copy of the tree
_FLAGS = ("-O3", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return _BUILD_DIR / f"libvtaugment-{h.hexdigest()[:16]}.so"


def _build_lib() -> Optional[Path]:
    """Compile augment.cpp into the build directory (once per source and
    flags; a unique temporary name, then an atomic rename, so concurrent
    processes never load a half-written library); None on failure."""
    out = _lib_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (subprocess.SubprocessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build_lib()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
            lib.fused_augment.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.fused_augment.restype = None
            _LIB = lib
        except OSError:
            _LIB = None
        return _LIB


def available() -> bool:
    return _load() is not None


def fused_augment(images: np.ndarray, rng: np.random.RandomState,
                  pad: int = 4, flip_p: float = 0.5,
                  brightness: float = 63 / 255) -> Optional[np.ndarray]:
    """Fused crop+flip+brightness over a uint8 NHWC batch.

    Returns None when the native library is unavailable (callers fall back
    to the numpy pipeline). RNG draws match the numpy path's order so the
    two paths are seed-compatible: crop offsets, flips, factors.
    """
    lib = _load()
    if lib is None:
        return None  # before consuming any rng draws
    n, h, w, c = images.shape
    ys = rng.randint(0, 2 * pad + 1, n).astype(np.int32)
    xs = rng.randint(0, 2 * pad + 1, n).astype(np.int32)
    flips = (rng.rand(n) < flip_p).astype(np.uint8)
    factors = rng.uniform(1 - brightness, 1 + brightness, n).astype(np.float32)
    images = np.ascontiguousarray(images)
    out = np.empty_like(images)
    lib.fused_augment(
        images.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        n, h, w, c, pad,
        ys.ctypes.data_as(ctypes.c_void_p),
        xs.ctypes.data_as(ctypes.c_void_p),
        flips.ctypes.data_as(ctypes.c_void_p),
        factors.ctypes.data_as(ctypes.c_void_p),
    )
    return out
