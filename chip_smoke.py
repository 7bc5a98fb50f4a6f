#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vision_transformers_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a traceback and a nonzero
exit, and without the final result line:

1. Device and build: the card's name and power limit, then every CUDA
   kernel of the port built from ``vision_transformers_tpu_torch/csrc``
   (one ``nvcc`` per source, all in parallel).
2. Kernels against their plain PyTorch versions, on the card, in bf16 and
   fp32, at the shapes the serving path gives them.
3. Main path: ViT-B/16 @224 (``vitb16_224_imagenet``, full width, weights
   from a seeded numpy draw, head included) served in bf16 through
   ``export_classifier`` → ``load_classifier`` → ``warmup`` → ``predict``
   (n = 1, 5, 8, 40) → 16 concurrent ``Microbatcher.submit`` calls. The
   packed kernel must launch 12 times per forward. Served logits are held
   against the same weights run on the CPU through the plain versions.
4. Split-head path: a 2-layer ViT-B-width model at 512 px (S = 1025, where
   ``packed_flash_supported`` is false), through the split-head kernel.
5. Times: serving latency per bucket, and each kernel beside its bound, its
   plain version and the PyTorch library call for the same function.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and tensor-core
# bf16 FLOP/s; fp32 work on the CUDA cores peaks at 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# |kernel - plain| on the same card inputs. fp32: summation order only.
# bf16: the plain version rounds the unnormalised probabilities to bf16
# before PV (as the TPU kernel does) while the kernel keeps them fp32, plus
# one bf16 rounding of outputs of magnitude <= 4 (2^-7 per ulp there).
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LSE_TOL = 1e-4
# Served logits (magnitude ~1) against the CPU fp32 run of the same weights:
# fp32 differs by summation order through 12 layers; bf16 rounds every
# activation and weight (8 significant bits), so it is held to 5% of the
# largest reference logit.
LOGIT_TOL_FP32 = 1e-3
LOGIT_TOL_BF16_REL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def seeded_state_dict(model, seed: int):
    """Every parameter from one numpy stream: Dense weights with xavier
    scale, LayerNorm scales 1 + N(0, 0.1), everything else N(0, 0.02)."""
    import torch

    rng = np.random.RandomState(seed)
    out = {}
    for name, p in model.state_dict().items():
        shape = tuple(p.shape)
        if name.endswith("weight") and len(shape) == 2:
            a = rng.standard_normal(shape) * (2.0 / sum(shape)) ** 0.5
        elif name.endswith("weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.02 * rng.standard_normal(shape)
        out[name] = torch.from_numpy(a.astype(np.float32))
    return out


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, top: int = 8):
    """One warm call of ``fn`` under ``torch.profiler`` → (wall ms, device
    busy ms, device activities, [(name, ms, count)] by device time), or
    busy None if the profiler recorded no device activity. One stream, so
    kernel times do not overlap and their sum is the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    if not by_name:
        return wall, None, 0, []
    busy = sum(ms for ms, _ in by_name.values())
    count = sum(n for _, n in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return wall, busy, count, [(k[:90], ms, n) for k, (ms, n) in ranked]


def bound_ms(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    import torch.nn.functional as F

    from vision_transformers_tpu_torch import serving
    from vision_transformers_tpu_torch.models.image_classification import ViT
    from vision_transformers_tpu_torch.ops import _build
    from vision_transformers_tpu_torch.ops import flash_attention as fa
    from vision_transformers_tpu_torch.utils.args import get_args

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    bf16, fp32 = torch.bfloat16, torch.float32

    # ---- 1. device and build ---------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {kind}")
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    build_s = _build.build()
    log(f"kernel build: {build_s:.2f} s for {list(_build.KERNELS)}")
    for name, out in _build.build_log.items():
        for line in out.splitlines():
            if "registers" in line:
                log(f"  ptxas[{name}]: {line.strip()}")

    # ---- 2. kernels against their plain versions -------------------------
    def randn(seed, *shape, dtype):
        g = torch.Generator(device="cpu").manual_seed(seed)
        return torch.randn(*shape, generator=g).to(dev, dtype)

    errs = {}

    def check_packed(label, b, s, h, dh, kv_valid, dtype):
        qkv = randn(1, b, s, 3 * h * dh, dtype=dtype)
        out, lse = fa.packed_flash_attention_fwd(qkv, h, kv_valid=kv_valid)
        ref, ref_lse = fa.packed_flash_attention_reference(
            qkv, h, kv_valid=kv_valid)
        torch.cuda.synchronize()
        e, el = max_err(out, ref), max_err(lse, ref_lse)
        name = str(dtype).removeprefix("torch.")
        log(f"packed {label} {name}: max|out-plain| {e:.3e} "
            f"(tol {KERNEL_TOL[name]}), max|lse-plain| {el:.3e}")
        require(bool(torch.isfinite(out).all()) and e <= KERNEL_TOL[name]
                and el <= LSE_TOL, f"packed {label} {name} against its plain version")
        errs[("packed", label, name)] = e

    def check_flash(label, b, h, sq, sk, d, bias_lead, kv_valid, dtype):
        q = randn(2, b, h, sq, d, dtype=dtype)
        k = randn(3, b, h, sk, d, dtype=dtype)
        v = randn(4, b, h, sk, d, dtype=dtype)
        bias = (None if bias_lead is None
                else randn(5, bias_lead, h, sq, sk, dtype=fp32))
        out, lse = fa.flash_attention_fwd(q, k, v, bias, kv_valid=kv_valid)
        ref, ref_lse = fa.flash_attention_reference(q, k, v, bias,
                                                    kv_valid=kv_valid)
        torch.cuda.synchronize()
        e, el = max_err(out, ref), max_err(lse, ref_lse)
        name = str(dtype).removeprefix("torch.")
        log(f"split {label} {name}: max|out-plain| {e:.3e} "
            f"(tol {KERNEL_TOL[name]}), max|lse-plain| {el:.3e}")
        require(bool(torch.isfinite(out).all()) and e <= KERNEL_TOL[name]
                and el <= LSE_TOL, f"split {label} {name} against its plain version")
        errs[("flash", label, name)] = e

    for dtype in (bf16, fp32):
        check_packed("vitb16@224 B32 S197", 32, 197, 12, 64, None, dtype)
        check_packed("S208 kv_valid197", 32, 208, 12, 64, 197, dtype)
        check_packed("swin-head dh32", 8, 49, 3, 32, None, dtype)
        check_flash("vitb16@512 G96 S1025", 8, 12, 1025, 1025, 64, None,
                    None, dtype)
        for lead, what in ((1, "shared"), (4, "per-window"),
                           (8, "per-group")):
            check_flash(f"swin N49 bias {what}", 8, 3, 49, 49, 32, lead,
                        None, dtype)
        check_flash("cross Sq3136 Sk49", 2, 1, 3136, 49, 64, None, None,
                    dtype)
        check_flash("kv_valid 60/70", 4, 3, 70, 70, 32, 1, 60, dtype)

    # ---- 3. main path: ViT-B/16 @224 served in bf16 ----------------------
    args = get_args("vitb16_224_imagenet")
    shape = (args["image_size"], args["image_size"], 3)
    model = ViT(**args, dtype="bfloat16")
    weights = seeded_state_dict(model, seed=0)
    model.load_state_dict(weights)
    rng = np.random.RandomState(1)
    images = rng.standard_normal((40, *shape)).astype(np.float32)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        serving.export_classifier(model, shape, tmp, buckets=(1, 8, 32),
                                  dtype=fp32)
        del model
        clf = serving.load_classifier(tmp)
    forwards = [0]
    clf.model.register_forward_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))

    fa.reset_launch_counts()
    t0 = time.perf_counter()
    clf.warmup()
    served = {n: clf.predict(images[:n]) for n in (1, 5, 8, 40)}
    mb = serving.Microbatcher(clf, max_wait_ms=5.0)
    mb_out = [None] * 16
    threads = [threading.Thread(
        target=lambda i=i: mb_out.__setitem__(i, mb.submit(images[i])))
        for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    require(not any(t.is_alive() for t in threads), "microbatcher answers")
    mb.close()
    torch.cuda.synchronize()
    main_launches = dict(fa.LAUNCHES)
    main_forwards = forwards[0]
    log(f"main path: {main_forwards} forwards in "
        f"{time.perf_counter() - t0:.2f} s, launches {main_launches}")
    require(main_forwards > 0 and main_launches["packed_attention"]
            == 12 * main_forwards, "packed kernel: 12 launches per forward")

    for n, out in served.items():
        require(out.shape == (n, args["num_classes"])
                and bool(torch.isfinite(out.float()).all()),
                f"predict({n}) gives finite ({n}, classes) logits")
    require(all(o is not None and o.shape == (args["num_classes"],)
                and np.isfinite(o).all() for o in mb_out),
            "every microbatched request gets finite logits")
    e_mb = float(np.abs(np.stack(mb_out)
                        - served[40][:16].float().cpu().numpy()).max())
    log(f"microbatcher vs predict(40): max|diff| {e_mb:.3e}")

    # the same weights on the CPU through the plain versions, fp32
    cpu_model = ViT(**args, device="cpu")
    cpu_model.load_state_dict(weights)
    ref = cpu_model(torch.from_numpy(images[:2])).float()
    ref_scale = ref.abs().max().item()
    e_bf16 = max_err(served[5][:2].cpu(), ref)
    log(f"bf16 served logits vs CPU fp32: max|diff| {e_bf16:.3e} "
        f"(max|ref| {ref_scale:.3f}, tol {LOGIT_TOL_BF16_REL} x max|ref|)")
    require(e_bf16 <= LOGIT_TOL_BF16_REL * ref_scale
            and e_mb <= LOGIT_TOL_BF16_REL * ref_scale,
            "bf16 served logits against the CPU run")

    model32 = ViT(**args)
    model32.load_state_dict(weights)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        serving.export_classifier(model32, shape, tmp, buckets=(2,),
                                  dtype=fp32)
        del model32
        clf32 = serving.load_classifier(tmp)
    e_fp32 = max_err(clf32.predict(images[:2]).cpu(), ref)
    log(f"fp32 served logits vs CPU fp32: max|diff| {e_fp32:.3e} "
        f"(tol {LOGIT_TOL_FP32})")
    require(e_fp32 <= LOGIT_TOL_FP32, "fp32 served logits against the CPU run")
    del clf32

    # ---- 4. split-head path: S = 1025 -----------------------------------
    wide = dict(args, image_size=512, num_layers=2)
    split_models = {d: ViT(**wide, dtype=d) for d in ("float32", "bfloat16")}
    split_weights = seeded_state_dict(split_models["float32"], seed=2)
    for m in split_models.values():
        m.load_state_dict(split_weights)
    x512 = torch.from_numpy(
        rng.standard_normal((2, 512, 512, 3)).astype(np.float32))
    fa.reset_launch_counts()
    with torch.inference_mode():
        split_out = {d: m(x512.to(dev)) for d, m in split_models.items()}
    torch.cuda.synchronize()
    split_launches = dict(fa.LAUNCHES)
    log(f"split-head path (2 layers @512, S=1025, fp32 + bf16): launches "
        f"{split_launches}")
    require(split_launches["flash_attention"] == 2 * 2
            and split_launches["packed_attention"] == 0,
            "split-head kernel: 1 launch per layer per forward at S=1025")
    cpu_wide = ViT(**wide, device="cpu")
    cpu_wide.load_state_dict(split_weights)
    ref512 = cpu_wide(x512).float()
    e32 = max_err(split_out["float32"].cpu(), ref512)
    e16 = max_err(split_out["bfloat16"].cpu(), ref512)
    scale512 = ref512.abs().max().item()
    log(f"split-head logits vs CPU fp32: fp32 {e32:.3e} (tol "
        f"{LOGIT_TOL_FP32}), bf16 {e16:.3e} (max|ref| {scale512:.3f})")
    require(e32 <= LOGIT_TOL_FP32 and e16 <= LOGIT_TOL_BF16_REL * scale512,
            "S=1025 logits against the CPU run")
    del split_models, cpu_wide, cpu_model

    # ---- 5. times ---------------------------------------------------------
    for b in clf.buckets:
        x = images[:b]
        for _ in range(2):
            clf.predict(x).float().cpu()
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            clf.predict(x).float().cpu()
        ms = (time.perf_counter() - t0) / iters * 1e3
        log(f"serving bf16 bucket {b}: {ms:.3f} ms per request "
            f"(host numpy in, logits out), {b / ms * 1e3:.1f} images/s")
    with torch.inference_mode():
        xb = torch.from_numpy(images[:32]).to(dev)
        fwd_ms = cuda_ms(lambda: clf.model(xb), iters=10)
    log(f"ViT-B/16 bf16 forward, batch 32, device time: {fwd_ms:.3f} ms "
        f"({32 / fwd_ms * 1e3:.1f} images/s)")
    for b in (1, 32):
        wall, busy, count, top = device_profile(
            lambda: clf.predict(images[:b]).float().cpu())
        if busy is None:
            log(f"profile bucket {b}: the profiler saw no device activity")
            continue
        log(f"profile bucket {b}: wall {wall:.3f} ms (profiler on), device "
            f"busy {busy:.3f} ms in {count} activities, idle share "
            f"{1 - busy / wall:.3f}")
        for name, ms, n in top:
            log(f"  {ms:8.3f} ms {n:4d}x {name}")

    kernels = []
    # packed: ViT-B/16 @224, batch 32, bf16 — the main path's launch shape
    b, s, h, dh = 32, 197, 12, 64
    qkv = randn(6, b, s, 3 * h * dh, dtype=bf16)
    qv, kv, vv = (t.view(b, s, h, dh).transpose(1, 2)
                  for t in qkv.split(h * dh, dim=-1))
    k_ms = cuda_ms(lambda: fa.packed_flash_attention_fwd(qkv, h))
    p_ms = cuda_ms(lambda: fa.packed_flash_attention_reference(qkv, h))
    l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qv, kv, vv))
    bnd, by = bound_ms((b * s * 3 * h * dh + b * s * h * dh) * 2
                       + b * s * h * 4, 4 * b * h * s * s * dh, "bfloat16")
    kernels.append(dict(
        name="packed_attention", route="cuda",
        source="vision_transformers_tpu_torch/csrc/packed_attention.cu",
        replaces="vision_transformers_tpu/ops/flash_attention.py:796",
        launches=main_launches["packed_attention"],
        max_abs_err=errs[("packed", "vitb16@224 B32 S197", "bfloat16")],
        ms=k_ms, plain_ms=p_ms, bound_ms=bnd, bound_by=by, library_ms=l_ms))
    log(f"packed_attention B{b} S{s} H{h} dh{dh} bf16: kernel {k_ms:.4f} ms, "
        f"bound {bnd:.4f} ms ({by}), plain {p_ms:.4f} ms, sdpa {l_ms:.4f} ms; "
        f"x12 layers = {12 * k_ms:.3f} ms of the {fwd_ms:.3f} ms forward")

    # split-head: ViT-B/16 @512, batch 8, bf16 — the S = 1025 path's shape
    b, h, s, d = 8, 12, 1025, 64
    q, k, v = (randn(7 + i, b, h, s, d, dtype=bf16) for i in range(3))
    k_ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v), iters=10)
    p_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v), iters=10)
    l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=10)
    bnd, by = bound_ms(4 * b * h * s * d * 2 + b * h * s * 4,
                       4 * b * h * s * s * d, "bfloat16")
    kernels.append(dict(
        name="flash_attention", route="cuda",
        source="vision_transformers_tpu_torch/csrc/flash_attention.cu",
        replaces="vision_transformers_tpu/ops/flash_attention.py:75",
        launches=split_launches["flash_attention"],
        max_abs_err=errs[("flash", "vitb16@512 G96 S1025", "bfloat16")],
        ms=k_ms, plain_ms=p_ms, bound_ms=bnd, bound_by=by, library_ms=l_ms))
    log(f"flash_attention G{b * h} S{s} D{d} bf16: kernel {k_ms:.4f} ms, "
        f"bound {bnd:.4f} ms ({by}), plain {p_ms:.4f} ms, sdpa {l_ms:.4f} ms")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
