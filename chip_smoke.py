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
   fp32, at the shapes the serving and training paths give them; the
   dropout and backward kernels at rate 0 and 0.1 under one seed (so both
   sides drop the same probabilities), the measured keep rate, the
   gradient through forward and backward of one seed against autograd of
   the plain forward, and bit-equal gradients from two runs.
3. Main path: ViT-B/16 @224 (``vitb16_224_imagenet``, full width, weights
   from a seeded numpy draw, head included) served in bf16 through
   ``export_classifier`` → ``load_classifier`` → ``warmup`` → ``predict``
   (n = 1, 5, 8, 40) → 16 concurrent ``Microbatcher.submit`` calls. The
   packed kernel must launch 12 times per forward. Served logits are held
   against the same weights run on the CPU through the plain versions.
4. Split-head path: a 2-layer ViT-B-width model at 512 px (S = 1025, where
   ``packed_flash_supported`` is false), through the split-head kernel.
5. Training paths. ``ViT.train_model`` on ``vit_tiny_cifar100`` (full size,
   fp32, dropout 0.1, a seeded colour-class loader with a ragged last
   batch) for 3 epochs; 3 Adam steps of ViT-B/16 @224 in bf16 at batch 32
   with ``attention_dropout=0.1`` and the step's split into forward,
   backward and optimizer; one step each with and without dropout of the
   2-layer model at 512 px (the split-head kernels); and fp32 gradients of
   a 2-layer model on the card against the CPU run of the same weights.
6. Times: serving latency per bucket, and each kernel beside its bound, its
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
# Gradients of a kernel against its plain version, relative to the largest
# reference element (gradients grow with S). fp32: summation order and expf
# against torch.exp. bf16: the plain versions round the probabilities and ds
# to bf16 before their products, as the TPU kernels do, while the CUDA
# kernels keep them in fp32; plus one bf16 rounding of the result.
GRAD_TOL = {"float32": 5e-5, "bfloat16": 2e-2}
# fp32 parameter gradients of a 2-layer model, card against CPU: summation
# order through two blocks, relative to the largest reference gradient.
MODEL_GRAD_TOL = 1e-4
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


class ColorClassLoader:
    """Re-iterable loader of (uint8 NHWC images, labels): each class is a
    colour plus noise, so a small model learns it in a few steps (the recipe
    of tests/synthetic_data.py). Class colours come from one fixed seed, so
    every split shares them; labels and noise come from ``seed``."""

    def __init__(self, num_samples, batch_size, image_size=32, num_classes=10,
                 seed=0):
        base = np.random.RandomState(1234).randint(0, 255, (num_classes, 3))
        rng = np.random.RandomState(seed)
        self.labels = rng.randint(0, num_classes, num_samples).astype(np.int32)
        noise = rng.randint(-20, 20, (num_samples, image_size, image_size, 3))
        self.images = np.clip(base[self.labels][:, None, None, :] + noise,
                              0, 255).astype(np.uint8)
        self.batch_size = batch_size
        self.normalize = ((0.5, 0.5, 0.5), (0.25, 0.25, 0.25))

    def __iter__(self):
        for i in range(0, len(self.labels), self.batch_size):
            yield (self.images[i:i + self.batch_size],
                   self.labels[i:i + self.batch_size])

    def __len__(self):
        return -(-len(self.labels) // self.batch_size)


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
    from vision_transformers_tpu_torch.training import trainer
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

    def grad_err(label, got, ref, name):
        e = max_err(got, ref)
        tol = GRAD_TOL[name] * max(1.0, ref.float().abs().max().item())
        require(bool(torch.isfinite(got.float()).all()) and e <= tol,
                f"{label} against its plain version ({e:.3e} > {tol:.3e})")
        return e, tol

    def check_packed_train(label, b, s, h, dh, kv_valid, dtype, rate):
        """Packed forward with dropout and packed backward against their
        plain versions under one seed, and the backward twice."""
        name = str(dtype).removeprefix("torch.")
        qkv = randn(11, b, s, 3 * h * dh, dtype=dtype)
        do = randn(12, b, s, h * dh, dtype=dtype)
        kw = dict(dropout_rate=rate, seed=20261016 + (5 << 40),
                  kv_valid=kv_valid)
        out, lse = fa.packed_flash_attention_fwd(qkv, h, **kw)
        ref, ref_lse = fa.packed_flash_attention_reference(qkv, h, **kw)
        e, el = max_err(out, ref), max_err(lse, ref_lse)
        require(bool(torch.isfinite(out.float()).all())
                and e <= KERNEL_TOL[name] and el <= LSE_TOL,
                f"packed fwd {label} {name} rate {rate} against its plain version")
        # both backwards from the plain (out, lse): only the backward differs
        dqkv = fa.packed_flash_attention_bwd(qkv, do, ref, ref_lse, h, **kw)
        dref = fa.packed_flash_attention_bwd_reference(qkv, do, ref, ref_lse,
                                                       h, **kw)
        eg, tol = grad_err(f"packed bwd {label} {name} rate {rate}", dqkv,
                           dref, name)
        again = fa.packed_flash_attention_bwd(qkv, do, ref, ref_lse, h, **kw)
        torch.cuda.synchronize()
        require(torch.equal(dqkv, again),
                f"packed bwd {label} {name}: two runs give equal gradients")
        log(f"packed {label} {name} rate {rate}: fwd max|out-plain| {e:.3e} "
            f"(tol {KERNEL_TOL[name]}), bwd max|dqkv-plain| {eg:.3e} "
            f"(tol {tol:.3e}), rerun bit-equal")
        errs[("packed_fwd", label, name, rate)] = e
        errs[("packed_bwd", label, name, rate)] = eg

    def check_drop(label, b, h, sq, sk, d, kv_valid, masked, dtype, rate):
        """Split-head dropout forward and backward (rows 5 and 6) against
        their plain versions under one seed, and the backward twice."""
        name = str(dtype).removeprefix("torch.")
        q = randn(13, b, h, sq, d, dtype=dtype)
        k = randn(14, b, h, sk, d, dtype=dtype)
        v = randn(15, b, h, sk, d, dtype=dtype)
        do = randn(16, b, h, sq, d, dtype=dtype)
        key_mask = None
        if masked:
            m = np.random.RandomState(17).rand(b, sk) > 0.3
            m[:, 0] = True
            key_mask = torch.from_numpy(m).to(dev)
        kw = dict(dropout_rate=rate, seed=777 + (9 << 35), kv_valid=kv_valid,
                  key_mask=key_mask)
        out, lse = fa.flash_dropout_attention_fwd(q, k, v, **kw)
        ref, ref_lse = fa.flash_dropout_attention_reference(q, k, v, **kw)
        e, el = max_err(out, ref), max_err(lse, ref_lse)
        require(bool(torch.isfinite(out.float()).all())
                and e <= KERNEL_TOL[name] and el <= LSE_TOL,
                f"dropout fwd {label} {name} rate {rate} against its plain version")
        got = fa.flash_dropout_attention_bwd(q, k, v, do, ref, ref_lse, **kw)
        want = fa.flash_dropout_attention_bwd_reference(q, k, v, do, ref,
                                                        ref_lse, **kw)
        eg = max(grad_err(f"dropout bwd {label} {name} rate {rate} d{n}", g,
                          w, name)[0] for n, g, w in zip("qkv", got, want))
        again = fa.flash_dropout_attention_bwd(q, k, v, do, ref, ref_lse, **kw)
        torch.cuda.synchronize()
        require(all(torch.equal(a, g) for a, g in zip(again, got)),
                f"dropout bwd {label} {name}: two runs give equal gradients")
        log(f"dropout {label} {name} rate {rate}: fwd max|out-plain| {e:.3e}, "
            f"bwd max|grad-plain| {eg:.3e} (tol {GRAD_TOL[name]} x "
            f"max(1, max|ref|)), rerun bit-equal")
        errs[("drop_fwd", label, name, rate)] = e
        errs[("drop_bwd", label, name, rate)] = eg

    for dtype in (bf16, fp32):
        for rate in (0.0, 0.1):
            check_packed_train("vitb16@224 B32 S197", 32, 197, 12, 64, None,
                               dtype, rate)
            check_packed_train("S208 kv_valid197", 32, 208, 12, 64, 197,
                               dtype, rate)
            check_packed_train("vit_tiny B64 S65", 64, 65, 4, 64, None,
                               dtype, rate)
            check_drop("vitb16@512 G96 S1025", 8, 12, 1025, 1025, 64, None,
                       False, dtype, rate)
            check_drop("cross Sq3136 Sk49", 2, 1, 3136, 49, 64, None, False,
                       dtype, rate)
            check_drop("key mask S70", 4, 3, 70, 70, 32, None, True, dtype,
                       rate)
            check_drop("kv_valid 60/70 + key mask", 4, 3, 70, 70, 32, 60,
                       True, dtype, rate)

    # the kernel's mask is the plain function's mask: with q = 0 and v the
    # identity, the output is the dropped probability matrix itself
    rate, seed = 0.1, 4242 + (3 << 33)
    zq = torch.zeros(8, 4, 64, 64, device=dev)
    eye = torch.eye(64, device=dev).expand(8, 4, 64, 64).contiguous()
    pd, _ = fa.flash_dropout_attention_fwd(zq, zq, eye, dropout_rate=rate,
                                           seed=seed)
    keep = fa.dropout_keep_mask(seed, rate, 32, 64, 64, dev)
    require(torch.equal(pd.reshape(32, 64, 64) > 0, keep),
            "the kernel drops exactly the probabilities the plain mask drops")
    big = fa.dropout_keep_mask(seed, rate, 96, 1025, 1025, dev)
    kept, n = big.float().mean().item(), big.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    log(f"dropout keep rate over {n} bits: {kept:.6f} (1 - r = {1 - rate}, "
        f"3 sigma = {3 * sigma:.2e})")
    require(abs(kept - (1 - rate)) <= 3 * sigma, "keep rate within 3 sigma")
    require(not torch.equal(keep, fa.dropout_keep_mask(seed + 1, rate, 32, 64,
                                                       64, dev)),
            "another seed gives another mask")
    del big

    # forward and backward of one seed replay one mask: the gradient through
    # the two kernels against autograd of the plain forward (fp32)
    qkv = randn(18, 4, 197, 3 * 12 * 64, dtype=fp32).requires_grad_()
    do = randn(19, 4, 197, 12 * 64, dtype=fp32)
    fa.packed_flash_attention(qkv, 12, dropout_rate=0.1, seed=31).backward(do)
    oracle = qkv.detach().clone().requires_grad_()
    fa.packed_flash_attention_reference(oracle, 12, dropout_rate=0.1,
                                        seed=31)[0].backward(do)
    e_replay, _ = grad_err("packed fwd+bwd mask replay", qkv.grad,
                           oracle.grad, "float32")
    qs, ks_, vs_ = (randn(20 + i, 2, 12, 300, 64, dtype=fp32).requires_grad_()
                    for i in range(3))
    do = randn(23, 2, 12, 300, 64, dtype=fp32)
    fa.flash_dropout_attention(qs, ks_, vs_, dropout_rate=0.1,
                               seed=32).backward(do)
    oracles = [t.detach().clone().requires_grad_() for t in (qs, ks_, vs_)]
    fa.flash_dropout_attention_reference(*oracles, dropout_rate=0.1,
                                         seed=32)[0].backward(do)
    e_replay = max(e_replay, *(grad_err(
        "split-head fwd+bwd mask replay", t.grad, o.grad, "float32")[0]
        for t, o in zip((qs, ks_, vs_), oracles)))
    log(f"mask replay, kernels' gradient vs autograd of the plain forward "
        f"(fp32, rate 0.1): max|diff| {e_replay:.3e}")
    del qkv, oracle, qs, ks_, vs_, oracles, do, zq, eye

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

    # ---- 5. training paths ------------------------------------------------
    # 5a. train_model on vit_tiny_cifar100: full size, fp32, dropout 0.1
    tiny_args = get_args("vit_tiny_cifar100")
    tiny = ViT(**tiny_args)
    train_loader = ColorClassLoader(1000, 64, seed=0)   # 15 x 64 + 40
    test_loader = ColorClassLoader(200, 64, seed=1)
    val_loader = ColorClassLoader(100, 64, seed=2)
    steps_per_epoch, epochs = len(train_loader), 3
    eval_forwards = epochs * (len(test_loader) + len(val_loader))
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    history = tiny.train_model(tiny, train_loader, test_loader, epochs,
                               val_loader, lr=1e-3, verbose=False)
    torch.cuda.synchronize()
    tiny_s = time.perf_counter() - t0
    tiny_launches = dict(fa.LAUNCHES)
    train_steps = history["final_state"].step
    log(f"train_model vit_tiny_cifar100, {epochs} epochs x {steps_per_epoch} "
        f"steps of 64 in {tiny_s:.2f} s: train loss "
        f"{[round(x, 4) for x in history['train_loss']]}, train acc "
        f"{[round(x, 4) for x in history['train_accuracy']]}, test acc "
        f"{[round(x, 4) for x in history['test_accuracy']]}, launches "
        f"{tiny_launches}")
    keys = {f"{split}_{m}" for split in ("train", "val", "test")
            for m in ("loss", "accuracy")}
    require(keys <= set(history) and all(
        len(history[k]) == epochs and np.isfinite(history[k]).all()
        for k in keys), "history has the six keys, finite, one value per epoch")
    require(history["train_loss"][-1] < history["train_loss"][0]
            and history["train_accuracy"][-1] > 0.3,
            "vit_tiny: train loss falls and train accuracy passes 0.3")
    require(train_steps == epochs * steps_per_epoch
            and tiny_launches["packed_attention_bwd"]
            == tiny_args["num_layers"] * train_steps
            and tiny_launches["packed_attention"]
            == tiny_args["num_layers"] * (train_steps + eval_forwards),
            "vit_tiny: 7 packed forward and 7 packed backward launches per "
            "train step (and 7 forward launches per eval batch)")
    del tiny

    # 5b. ViT-B/16 @224, bf16, batch 32, attention dropout 0.1: 3 Adam steps
    vitb_args = dict(args, attention_dropout=0.1)
    vitb = ViT(**vitb_args, dtype="bfloat16")
    vitb.load_state_dict(weights)
    state = trainer.make_train_state(vitb, lr=1e-4)
    step = trainer.train_step_fn(vitb)
    xb = torch.from_numpy(images[:32]).to(dev)
    yb = torch.from_numpy(rng.randint(0, args["num_classes"], 32)).to(dev)
    wb = torch.ones(32, device=dev)
    vitb.dropout_generator.manual_seed(0)
    fa.reset_launch_counts()
    vitb_losses = []
    for _ in range(3):
        state, loss_n, _, n = step(state, xb, yb, wb)
        vitb_losses.append((loss_n / n).item())
    vitb_launches = dict(fa.LAUNCHES)
    log(f"ViT-B/16 bf16 batch 32 attention_dropout 0.1, 3 Adam steps on one "
        f"batch: loss {[round(x, 4) for x in vitb_losses]}, launches "
        f"{vitb_launches}")
    require(np.isfinite(vitb_losses).all()
            and vitb_losses[-1] < vitb_losses[0],
            "ViT-B: finite falling loss over 3 steps on one batch")
    require(vitb_launches["packed_attention"] == 12 * 3
            and vitb_launches["packed_attention_bwd"] == 12 * 3,
            "ViT-B: 12 packed forward and 12 packed backward launches per step")

    # the step's split, CUDA events around the three parts of train_step_fn
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
          for _ in range(5)]
    vitb.train()
    t0 = time.perf_counter()
    for e0, e1, e2, e3 in ev:
        e0.record()
        loss = trainer.cross_entropy_with_weights(vitb(xb), yb, wb)
        e1.record()
        state.optimizer.zero_grad()
        loss.backward()
        e2.record()
        state.optimizer.step()
        e3.record()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / len(ev) * 1e3
    fwd_t, bwd_t, opt_t = (float(np.mean([e[i].elapsed_time(e[i + 1])
                                          for e in ev])) for i in range(3))
    log(f"ViT-B/16 bf16 train step, batch 32: {step_ms:.3f} ms per step by the "
        f"host clock ({32 / step_ms * 1e3:.1f} images/s); device time forward "
        f"{fwd_t:.3f} ms, backward {bwd_t:.3f} ms, optimizer {opt_t:.3f} ms")
    train_fwd_ms, train_bwd_ms = fwd_t, bwd_t

    def one_step():
        loss = trainer.cross_entropy_with_weights(vitb(xb), yb, wb)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()

    wall, busy, count, top = device_profile(one_step, top=10)
    if busy is None:
        log("profile train step: the profiler saw no device activity")
    else:
        log(f"profile train step: wall {wall:.3f} ms (profiler on), device "
            f"busy {busy:.3f} ms in {count} activities, idle share "
            f"{1 - busy / wall:.3f}")
        for name, ms, n in top:
            log(f"  {ms:8.3f} ms {n:4d}x {name}")
    del vitb, state, step, loss

    # 5c. split-head training: 2 layers at 512 px (S = 1025), bf16, batch 2
    x512_2 = x512.to(dev)
    y512 = torch.tensor([1, 2], device=dev)
    w512 = torch.ones(2, device=dev)
    split_train_launches = {}
    for rate in (0.1, 0.0):
        m = ViT(**dict(wide, attention_dropout=rate), dtype="bfloat16")
        m.load_state_dict(split_weights)
        st = trainer.make_train_state(m, lr=1e-4)
        fa.reset_launch_counts()
        st, loss_n, _, n = trainer.train_step_fn(m)(st, x512_2, y512, w512)
        loss_v = (loss_n / n).item()
        finite = all(bool(torch.isfinite(p).all()) for p in m.parameters())
        split_train_launches[rate] = dict(fa.LAUNCHES)
        log(f"split-head train step (2 layers @512, S=1025, bf16, attention "
            f"dropout {rate}): loss {loss_v:.4f}, launches "
            f"{split_train_launches[rate]}")
        require(np.isfinite(loss_v) and finite,
                f"split-head train step at rate {rate}: finite loss and "
                "parameters")
        del m, st
    want = {0.1: {"dropout_attention_fwd": 2, "dropout_attention_bwd": 2,
                  "flash_attention": 0},
            0.0: {"dropout_attention_fwd": 0, "dropout_attention_bwd": 2,
                  "flash_attention": 2}}
    require(all(split_train_launches[r][k] == v and
                split_train_launches[r]["packed_attention"] == 0
                for r, kv in want.items() for k, v in kv.items()),
            "split-head training: rows 5 and 6 with dropout; row 2 forward "
            "and row 6 backward without")

    # 5d. fp32 gradients, card against CPU (plain versions), 2 layers, rate 0
    small = dict(args, num_layers=2)
    grads = {}
    xg = torch.from_numpy(images[:2])
    yg = torch.tensor([3, 7])
    sd = seeded_state_dict(ViT(**small, device="cpu"), seed=4)
    for device in ("cpu", "cuda"):
        m = ViT(**small, device=device)
        m.load_state_dict(sd)
        m.train()
        fa.reset_launch_counts()
        loss = trainer.cross_entropy_with_weights(
            m(xg.to(device)), yg.to(device), torch.ones(2, device=device))
        loss.backward()
        grads[device] = (loss.item(), {n: p.grad.detach().cpu()
                                       for n, p in m.named_parameters()})
        if device == "cuda":
            require(fa.LAUNCHES["packed_attention_bwd"] == 2,
                    "card gradients went through the packed backward kernel")
    g_ref = max(g.abs().max().item() for g in grads["cpu"][1].values())
    e_grad = max(max_err(grads["cuda"][1][n], g)
                 for n, g in grads["cpu"][1].items())
    log(f"fp32 gradients of a 2-layer ViT-B-width model, card vs CPU: loss "
        f"{grads['cuda'][0]:.6f} vs {grads['cpu'][0]:.6f}, max|dgrad| "
        f"{e_grad:.3e} (max|ref| {g_ref:.3e}, tol {MODEL_GRAD_TOL} x "
        f"max(1, max|ref|))")
    require(abs(grads["cuda"][0] - grads["cpu"][0]) <= 1e-4
            and e_grad <= MODEL_GRAD_TOL * max(1.0, g_ref),
            "card gradients against the CPU run of the same weights")
    del grads

    # ---- 6. times ---------------------------------------------------------
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
    port = "vision_transformers_tpu_torch/csrc/"
    jax_file = "vision_transformers_tpu/ops/flash_attention.py"

    def sdpa_backward(q, k, v, do, p):
        """One call of SDPA's backward through autograd, graph kept."""
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, dropout_p=p)
        return lambda: torch.autograd.grad(out, (q, k, v), do,
                                           retain_graph=True)

    def entry(name, source, line, launches, err, shape, k_ms, p_ms, l_ms,
              nbytes, flops, **extra):
        bnd, by = bound_ms(nbytes, flops, "bfloat16")
        require(launches > 0, f"{name}: launched on its path")
        kernels.append(dict(
            name=name, route="cuda", source=port + source,
            replaces=f"{jax_file}:{line}", launches=launches, max_abs_err=err,
            ms=k_ms, plain_ms=p_ms, bound_ms=bnd, bound_by=by,
            library_ms=l_ms, **extra))
        more = "".join(f", {k} {v:.4f}" for k, v in extra.items())
        log(f"{name} {shape} bf16: kernel {k_ms:.4f} ms, bound {bnd:.4f} ms "
            f"({by}), plain {p_ms:.4f} ms, library {l_ms:.4f} ms{more}")

    # packed: ViT-B/16 @224, batch 32, bf16 — the serving and training shape
    b, s, h, dh = 32, 197, 12, 64
    rate, seed = 0.1, 2026
    shape = f"B{b} S{s} H{h} dh{dh}"
    qkv = randn(6, b, s, 3 * h * dh, dtype=bf16)
    do = randn(24, b, s, h * dh, dtype=bf16)
    qv, kv, vv = (t.view(b, s, h, dh).transpose(1, 2)
                  for t in qkv.split(h * dh, dim=-1))
    out, lse = fa.packed_flash_attention_fwd(qkv, h, dropout_rate=rate,
                                             seed=seed)
    io_bytes = b * s * h * dh * 2
    entry("packed_attention", "packed_attention.cu", 796,
          main_launches["packed_attention"] + tiny_launches["packed_attention"]
          + vitb_launches["packed_attention"],
          errs[("packed", "vitb16@224 B32 S197", "bfloat16")], shape,
          cuda_ms(lambda: fa.packed_flash_attention_fwd(qkv, h)),
          cuda_ms(lambda: fa.packed_flash_attention_reference(qkv, h)),
          cuda_ms(lambda: F.scaled_dot_product_attention(qv, kv, vv)),
          4 * io_bytes + b * s * h * 4, 4 * b * h * s * s * dh,
          dropout_ms=cuda_ms(lambda: fa.packed_flash_attention_fwd(
              qkv, h, dropout_rate=rate, seed=seed)))
    log(f"  x12 layers = {12 * kernels[-1]['ms']:.3f} ms of the {fwd_ms:.3f} "
        f"ms serving forward; with dropout x12 = "
        f"{12 * kernels[-1]['dropout_ms']:.3f} ms of the {train_fwd_ms:.3f} ms "
        "training forward")
    bwd_args = (qkv, do, out, lse, h)
    bwd_kw = dict(dropout_rate=rate, seed=seed)
    entry("packed_attention_bwd", "packed_attention.cu", 833,
          tiny_launches["packed_attention_bwd"]
          + vitb_launches["packed_attention_bwd"],
          errs[("packed_bwd", "vitb16@224 B32 S197", "bfloat16", rate)],
          shape + f" rate {rate}",
          cuda_ms(lambda: fa.packed_flash_attention_bwd(*bwd_args, **bwd_kw)),
          cuda_ms(lambda: fa.packed_flash_attention_bwd_reference(
              *bwd_args, **bwd_kw), iters=10),
          cuda_ms(sdpa_backward(qv, kv, vv, do.view(b, s, h, dh).transpose(1, 2),
                                rate)),
          8 * io_bytes + b * s * h * 4, 10 * b * h * s * s * dh,
          rate0_ms=cuda_ms(lambda: fa.packed_flash_attention_bwd(*bwd_args)))
    log(f"  x12 layers = {12 * kernels[-1]['ms']:.3f} ms of the "
        f"{train_bwd_ms:.3f} ms training backward")
    del qkv, do, out, lse, bwd_args

    # split-head: ViT-B/16 @512, batch 8, bf16 — the S = 1025 paths' shape
    b, h, s, d = 8, 12, 1025, 64
    shape = f"G{b * h} S{s} D{d}"
    q, k, v, do = (randn(7 + i, b, h, s, d, dtype=bf16) for i in range(4))
    io_bytes = b * h * s * d * 2
    lse_bytes = b * h * s * 4
    entry("flash_attention", "flash_attention.cu", 75,
          split_launches["flash_attention"]
          + split_train_launches[0.0]["flash_attention"],
          errs[("flash", "vitb16@512 G96 S1025", "bfloat16")], shape,
          cuda_ms(lambda: fa.flash_attention_fwd(q, k, v), iters=10),
          cuda_ms(lambda: fa.flash_attention_reference(q, k, v), iters=10),
          cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=10),
          4 * io_bytes + lse_bytes, 4 * b * h * s * s * d)
    kw = dict(dropout_rate=rate, seed=seed)
    entry("dropout_attention_fwd", "dropout_attention.cu", 491,
          split_train_launches[0.1]["dropout_attention_fwd"],
          errs[("drop_fwd", "vitb16@512 G96 S1025", "bfloat16", rate)],
          shape + f" rate {rate}",
          cuda_ms(lambda: fa.flash_dropout_attention_fwd(q, k, v, **kw),
                  iters=10),
          cuda_ms(lambda: fa.flash_dropout_attention_reference(q, k, v, **kw),
                  iters=5),
          cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                         dropout_p=rate),
                  iters=10),
          4 * io_bytes + lse_bytes, 4 * b * h * s * s * d)
    out, lse = fa.flash_dropout_attention_fwd(q, k, v, **kw)
    bwd_args = (q, k, v, do, out, lse)
    entry("dropout_attention_bwd", "dropout_attention.cu", 525,
          split_train_launches[0.1]["dropout_attention_bwd"]
          + split_train_launches[0.0]["dropout_attention_bwd"],
          errs[("drop_bwd", "vitb16@512 G96 S1025", "bfloat16", rate)],
          shape + f" rate {rate}",
          cuda_ms(lambda: fa.flash_dropout_attention_bwd(*bwd_args, **kw),
                  iters=5),
          cuda_ms(lambda: fa.flash_dropout_attention_bwd_reference(
              *bwd_args, **kw), iters=5),
          cuda_ms(sdpa_backward(q, k, v, do, rate), iters=10),
          8 * io_bytes + lse_bytes, 10 * b * h * s * s * d,
          rate0_ms=cuda_ms(lambda: fa.flash_dropout_attention_bwd(
              *bwd_args, dropout_rate=0.0, seed=None), iters=5))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
