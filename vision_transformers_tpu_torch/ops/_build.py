"""Build and load the CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` (Hopper)
into a shared library with a plain C interface, at first use, and loaded
with ``ctypes``. No PyTorch header is compiled, so a build takes seconds.
The libraries go to ``csrc/build/`` (listed in ``.gitignore``), named by a
hash of the sources and the flags: an edited source builds anew, an
unchanged one is reused, and so is the compiler's output kept beside it
(``build_log``, whose ``-Xptxas -v`` lines give each kernel's registers).

Nothing here runs at import: the CPU tests import every module, and this
machine-independent part is all they see.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
KERNELS = ("packed_attention", "flash_attention", "dropout_attention",
           "window_attention", "window_fused_attention",
           "window_attention_bwd", "fused_adam", "flash_attention_large",
           "flash_attention_bwd", "ln_dense", "fused_block",
           "flash_attention_bias_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# dropout arguments: threshold (32 bits), 1/(1-rate), seed (64 bits)
_L = ctypes.c_longlong
_DROP = [ctypes.c_uint32, _F, ctypes.c_uint64]
# C signatures: every pointer and the stream as c_void_p (a bare Python int
# would be passed as a 32-bit int and cut the pointer).
_SIGNATURES = {
    "packed_attention": {
        "packed_attention_fwd": (
            _I, [_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, *_DROP, _P]),
        "packed_attention_bwd": (
            _I, [_P] * 6 + [_I, _I, _I, _I, _I, _F, _I, *_DROP, _P]),
        "packed_attention_error_string": (ctypes.c_char_p, [_I]),
    },
    "flash_attention": {
        "flash_attention_fwd": (
            _I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P]),
        "flash_attention_error_string": (ctypes.c_char_p, [_I]),
    },
    "dropout_attention": {
        "dropout_attention_fwd": (
            _I, [_P] * 6 + [_I, _I, _I, _I, _I, _I, _F, _I, *_DROP, _P]),
        # (q, k, v, kmask, do, out, lse, dq, dk, dv, delta, part, g, heads,
        #  sq, sk, d, kv_valid, chunks, scale, is_bf16, *drop, stream)
        "dropout_attention_bwd": (
            _I, [_P] * 12 + [_I] * 7 + [_F, _I, *_DROP, _P]),
        "dropout_attention_tile_counts": (_I, [_P]),
        "dropout_attention_error_string": (ctypes.c_char_p, [_I]),
    },
    # (qkv, bias, out, g, n, heads, dh, bias_windows, scale, p, threads
    #  [, passes], is_bf16, stream)
    "window_attention": {
        "window_packed_attention_fwd": (
            _I, [_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P]),
        "window_batched_attention_fwd": (
            _I, [_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P]),
        "window_attention_error_string": (ctypes.c_char_p, [_I]),
    },
    # (qkv, bias, out, b, hp, wp, wh, ww, sh, sw, heads, dh, sec,
    #  bias_windows, scale, p, threads, is_bf16, stream)
    "window_fused_attention": {
        fn: (_I, [_P, _P, _P] + [_I] * 11 + [_F, _I, _I, _I, _P])
        for fn in ("window_fused_slab_attention_fwd",
                   "window_fused_flat_attention_fwd")
    } | {
        "window_fused_attention_error_string": (ctypes.c_char_p, [_I]),
    },
    # (qkv, bias, dout, dqkv, ds_out, g, n, heads, dh, bias_windows, scale,
    #  p, threads, is_bf16, stream)
    "window_attention_bwd": {
        "window_attention_bwd": (
            _I, [_P] * 5 + [_I] * 5 + [_F, _I, _I, _I, _P]),
        "window_attention_bwd_error_string": (ctypes.c_char_p, [_I]),
    },
    # (leaves: (L, 5) int64 of p, m, v, g, n; L, b1, b2, c1, c2, neg_lr,
    #  wd, eps, stream)
    "fused_adam": {
        "adam_multi": (_I, [_P, _I] + [_F] * 7 + [_P]),
        "fused_adam_error_string": (ctypes.c_char_p, [_I]),
    },
    # (q, k, v, kmask, out, lse, g, mask_rows, sq, sk, d, kv_valid, scale,
    #  is_bf16, stream)
    "flash_attention_large": {
        "flash_attention_large_fwd": (_I, [_P] * 6 + [_I] * 6 + [_F, _I, _P]),
        "flash_attention_large_tile_counts": (_I, [_P]),
        "flash_attention_large_error_string": (ctypes.c_char_p, [_I]),
    },
    # (q, k, v, out, lse, dout, dq, dk, dv, delta, g, sq, sk, d, kv_valid,
    #  scale, is_bf16, stream); delta: fp32 scratch, bf16 only
    "flash_attention_bwd": {
        "flash_attention_bwd": (_I, [_P] * 10 + [_I] * 5 + [_F, _I, _P]),
        "flash_attention_bwd_error_string": (ctypes.c_char_p, [_I]),
    },
    # (q, k, v, dout, out, lse, bias, dq, dk, dv, dbias, delta, part, groups,
    #  bias_g, sq, sk, d, kv_valid, rows, chunks, dq_smem, scale, stream):
    #  bf16 only
    "flash_attention_bias_bwd": {
        "flash_attention_bias_bwd": (_I, [_P] * 13 + [_I] * 9 + [_F, _P]),
        "flash_attention_bias_bwd_error_string": (ctypes.c_char_p, [_I]),
    },
    # (x, gamma, beta, w, ldk, ldn, bias, out, rows, d, n, eps, act, is_bf16,
    #  stream)
    "ln_dense": {
        "ln_dense_fwd": (_I, [_P] * 4 + [_L, _L, _P, _P, _I, _I, _I, _F, _I, _I,
                                         _P]),
        # (x, gamma, beta, w, ldk, ldn, bias, out, stats, rows, d, n, eps,
        #  act, stream): bf16 only, tensor cores; stats fp32 scratch
        "ln_dense_mma_fwd": (_I, [_P] * 4 + [_L, _L, _P, _P, _P, _I, _I, _I,
                                             _F, _I, _P]),
        "ln_dense_error_string": (ctypes.c_char_p, [_I]),
    },
    # (x, gamma, beta, wqkv, ldk1, ldn1, bqkv, wout, ldk3, ldn3, bout, qkv_ws,
    #  attn_ws, out, lse_ws, b, s, heads, dh, scale, eps, is_bf16, stream)
    "fused_block": {
        "fused_block_fwd": (_I, [_P] * 4 + [_L, _L, _P, _P, _L, _L] + [_P] * 5
                            + [_I] * 4 + [_F, _F, _I, _P]),
        # (x, gamma, beta, wqkv, ldk1, ldn1, bqkv, wout, ldk3, ldn3, bout,
        #  qkv_ws, attn_ws, out, stats, lse_ws, b, s, heads, dh, scale, eps,
        #  stream): bf16 only, tensor cores
        "fused_block_mma_fwd": (_I, [_P] * 4 + [_L, _L, _P, _P, _L, _L]
                                + [_P] * 6 + [_I] * 4 + [_F, _F, _P]),
        # the same with `phases` before the stream: measurement only
        "fused_block_mma_phases": (_I, [_P] * 4 + [_L, _L, _P, _P, _L, _L]
                                   + [_P] * 6 + [_I] * 4 + [_F, _F, _I,
                                                            _P]),
        "fused_block_error_string": (ctypes.c_char_p, [_I]),
    },
}

# Every library's launch log (csrc/launch_log.cuh): the kernel name in a
# slot, its launches since the last reset, the reset.
_LOG_SIGNATURES = {
    "vtt_launch_name": (ctypes.c_char_p, [_I]),
    "vtt_launch_count": (_L, [_I]),
    "vtt_launch_log_reset": (None, []),
}
_LOG_SLOTS = 32  # csrc/launch_log.cuh's LaunchLog::kSlots

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # name -> nvcc output of its library's build


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = KERNELS) -> float:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together. Returns the wall seconds; raises with the
    compiler's output if a build fails."""
    t0 = time.perf_counter()
    with _lock:
        todo = [(n, _lib_path(n)) for n in names]
        for name, path in todo:
            if path.exists() and path.with_suffix(".log").exists():
                build_log.setdefault(name,
                                     path.with_suffix(".log").read_text())
        todo = [(n, p) for n, p in todo if not p.exists()]
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name, path in todo:
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs.append((name, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, path, tmp, proc in procs:
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode == 0:
                # atomic: a reader never sees half a file, nor a library
                # without its log
                tmp.with_suffix(".log").write_text(out)
                os.replace(tmp.with_suffix(".log"), path.with_suffix(".log"))
                os.replace(tmp, path)
            else:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, (restype, argtypes) in (_SIGNATURES[name]
                                            | _LOG_SIGNATURES).items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _loaded[name] = lib
        return _loaded[name]


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a kernel's C entry returned a CUDA error code."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")


def reset_launched() -> None:
    """Zero every loaded library's launch log."""
    for lib in list(_loaded.values()):
        lib.vtt_launch_log_reset()


def launched() -> Dict[str, int]:
    """Launches of each kernel since ``reset_launched``, by the name its
    launch site gives (``csrc/launch_log.cuh``), over the loaded libraries:
    which kernels the C entries chose, read without a profiler. Kernels
    launched no time are left out."""
    counts: Dict[str, int] = {}
    for lib in list(_loaded.values()):
        for slot in range(_LOG_SLOTS):
            name = lib.vtt_launch_name(slot)
            if name is None:
                break
            n = lib.vtt_launch_count(slot)
            if n:
                counts[name.decode()] = counts.get(name.decode(), 0) + n
    return counts
