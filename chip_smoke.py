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
   the plain forward, and bit-equal gradients from two runs. The four
   window kernels at the shapes of Swin-T's and SwinV2-T's stages at batch
   32 and of a CIFAR window, with a shared and a per-window bias; the two
   fused ones with and without a shift into an output pre-filled with NaN
   (every element must be written), and against each other on one map.
   The window backward kernel at the same stage shapes (shared, per-window
   and no bias, with and without the bias gradient, dh 16/32/64) against
   its plain version and, in fp32, against autograd of the plain forward,
   into a dqkv pre-filled with NaN, twice for equal bits; gradients through
   the two fused kernels' autograd function against autograd of their plain
   version; the single-pass Adam kernel over leaves on both sides of 65 536
   elements against its plain version, in place. The streaming forward
   (``flash_attention_large``) at the DETR-R50 encoder's eval shape (batch
   4 at the 896 x 1344 bucket: G 32, S 4704, D 32, the key masks of four
   unequal COCO images), the decoder's cross shape (Sq 100, Sk 4704) and a
   bias-free, mask-free ViT-B shape at S 1297, with ``kv_valid`` < Sk, into
   an output pre-filled with NaN, twice for equal bits, and an image whose
   keys are all masked against ``mha_reference``; the small-S backward
   (``flash_attention_bwd``) at the DETR decoder's self attention and at
   ViT-B/16's S 197 against its plain version, the row-6 kernel at rate 0
   and, in fp32, autograd of the plain forward, into NaN-filled gradients,
   twice for equal bits. The fused LayerNorm + Dense (``ln_dense``) at
   benchmarks/ln_fused.py's ViT-B shapes at batch 32 ([ln_1 + QKV] and
   [ln_2 + fc1 + GELU], a ragged R without a bias, erf GELU in fp32) and the
   fused attention sub-block (``fused_attention_block``) at ViT-B/16,
   DeiT-B, T2T-ViT-14 and bucket 1, into NaN-filled outputs, twice for
   equal bits; gradients through both autograd functions in fp32. Rows 2
   and 6: bf16 launches go through the tensor-core kernels and fp32 ones
   through the CUDA-core kernels, by the kernels' names in a
   ``torch.profiler`` trace (here, and on the split-head forward of phase
   4, the split-head train steps of phase 6 and the DETR train steps of
   phase 7); the bf16 kernels at the paths' own shapes (row 2 at the DETR
   decoder's self attention, G 32, S 100, D 32, with and without a bias;
   row 6 at the DETR encoder, G 16, S 4704, D 32, with the key masks of two
   COCO images at rate 0.1, and at PVT stage 1, G 32, Sq 3136, Sk 49, D 64)
   against their plain versions, twice for equal bits.
3. Main path: ViT-B/16 @224 (``vitb16_224_imagenet``, full width, weights
   from a seeded numpy draw, head included) served in bf16 through
   ``export_classifier`` → ``load_classifier`` → ``warmup`` → ``predict``
   (n = 1, 5, 8, 40) → 16 concurrent ``Microbatcher.submit`` calls. The
   packed kernel must launch 12 times per forward. Served logits are held
   against the same weights run on the CPU through the plain versions.
4. Split-head path: a 2-layer ViT-B-width model at 512 px (S = 1025, where
   ``packed_flash_supported`` is false), through the split-head kernel.
5. Window path: ``swint_224_imagenet`` and ``swinv2t_224_imagenet`` (full
   width and depth, seeded weights) served in bf16 through the same entry
   points at buckets 1, 8 and 32. Per forward Swin-T must launch the
   batched window kernel 4 times, the fused slab kernel once and the fused
   flat kernel 7 times; SwinV2-T the batched kernel 4 times and the packed
   kernel 8 times; at every bucket, and no other attention kernel. Logits
   against the same weights on the CPU (bf16 served, and an fp32 model).
6. Training paths. ``ViT.train_model`` on ``vit_tiny_cifar100`` (full size,
   fp32, dropout 0.1, a seeded colour-class loader with a ragged last
   batch) for 3 epochs; 3 Adam steps of ViT-B/16 @224 in bf16 at batch 32
   with ``attention_dropout=0.1`` and the step's split into forward,
   backward and optimizer; one step each with and without dropout of the
   2-layer model at 512 px (the split-head kernels); and fp32 gradients of
   a 2-layer model on the card against the CPU run of the same weights.
   Then the windowed models' training: ``swint_224_imagenet`` and
   ``swinv2t_224_imagenet`` (full width and depth, bf16, batch 32) through
   ``make_train_state`` and ``train_step_fn`` with
   ``make_optimizer("adam", fused=True)`` and with ``fused=False``: per step
   the 12 forward window launches of phase 5, 12 ``window_attention_bwd``
   launches, one ``fused_adam`` launch per large leaf, and no other kernel
   of the table; the loss of the batch in eval mode must fall; the step's
   split and a profile; fp32 gradients of narrow 2-stage Swin and SwinV2
   models on the card against the CPU; ``train_model`` on
   ``swin_tiny_cifar100``. ``pvt_tiny224_imagenet`` and
   ``twins_svts224_imagenet`` served in bf16 (buckets 1 and 32, logits
   against the CPU) and trained for a few steps, with the kernels they
   launch and Twins' window routes. Then the ViT family on the
   ``USE_FUSED_BLOCK`` path: ViT-B/16, DeiT-B, CPE-ViT-B, T2T-ViT-14 and
   T2T-ViT_t-14 @224 (weights drawn into the JAX params layout, loaded
   through ``utils/port_jax.py``'s converters) served in bf16 at buckets 1,
   8 and 32 with the flag on (exactly 12, 12, 12, 14 and 14
   ``fused_attention_block`` launches per forward, no packed launch; the
   T2T_t one also 1 streaming and 1 split-head launch for its token
   transformer), then off (the packed kernel per layer), logits against
   each other and the CPU, fp32 on the card against the CPU; the three new
   models trained for 3 Adam steps in bf16 at batch 32 with the flag on (no
   fused launch in training mode, the batch's eval loss falls); and
   benchmarks/ln_fused.py's fused chain (12 layers, ``ln_dense`` twice per
   layer) against its library chain.
7. Detection: ``Detr(num_classes=91, aux_loss=True)`` (DETR-R50 DC5, full
   width and depth, weights drawn from a seed into the JAX package's params
   layout and loaded through ``detr_state_dict_from_jax``) on synthetic
   COCO-sized images. Eval in bf16 and fp32, batch 4 at the 896 x 1344
   bucket (4704 C5 tokens), through ``DetectionLoader`` → ``evaluate_model``
   with ``PostProcess``: exactly 12 streaming and 6 split-head launches per
   forward and no other kernel; forward time, images/s and a profile; fp32
   outputs against the CPU run of the same weights on one image padded to
   512 x 640. Training through ``fit_detection``, 3 steps at batch 2 on the
   same bucket, bf16: at dropout 0.1 18 dropout forward and 18 dropout
   backward launches per step; at dropout 0 with ``USE_PALLAS_BWD`` 12
   streaming, 6 split-head, 6 small-S backward and 12 row-6 backward
   launches per step; in both the batch's eval-mode loss must fall; the
   step's split and a profile. fp32 parameter gradients of a narrow DETR
   (hidden 32, 1 + 2 layers, full ResNet-50, 128 x 160) on the card against
   the CPU, with the diagnosis of their largest difference (the
   pre-activations of the ReLU after ``layer4_block2.conv1`` within rounding
   of 0 and on opposite sides on the two devices, and that weight gradient
   recomputed on the card with each device's ReLU mask); the auction's
   assignment on the step's cost against scipy's.
   One forward of the ViT-B backbone variant at the same bucket (24
   streaming launches: 12 unmasked in the backbone at S 4704, 12 masked).
8. Times: serving latency per bucket (the ViT family with the flag on and
   off), and each of the fifteen kernels beside its bound, its plain version
   and the PyTorch library call (or chain) for the same function; rows 2 and
   6 also at the path shapes of phase 2, with their TFLOP/s and SDPA's time.

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
# The window kernels against their plain versions. fp32: summation order and
# expf against torch.exp on outputs of magnitude <= 5. bf16: the plain
# versions round the normalised probabilities to bf16 before PV (as the TPU
# kernels do) while the kernels keep them fp32, plus one rounding of the output.
WINDOW_TOL = {"float32": 5e-6, "bfloat16": 2e-2}
# Gradients of a kernel against its plain version, relative to the largest
# reference element (gradients grow with S). fp32: summation order and expf
# against torch.exp. bf16: the plain versions round the probabilities and ds
# to bf16 before their products, as the TPU kernels do, while the CUDA
# kernels keep them in fp32; plus one bf16 rounding of the result.
GRAD_TOL = {"float32": 5e-5, "bfloat16": 2e-2}
# The bf16 tensor-core backward of row 6 against its plain version, relative
# to the largest reference element: both round pd and ds to bf16 before their
# products (as the TPU kernel does), so what is left is summation order and
# one rounding of the result (up to 3.1e-3 at PVT stage 1 on an H100).
MMA_GRAD_TOL = 5e-3
# Substrings of the CUDA kernels' names that tell the routes of rows 2 and 6
# apart in a profile (csrc/flash_attention.cu, csrc/dropout_attention.cu):
# bf16 on the tensor cores, fp32 on the CUDA cores.
ROUTE_NAMES = {
    ("row 2", "bfloat16"): ("flash_fwd_mma_kernel",),
    ("row 2", "float32"): ("flash_fwd_kernel",),
    ("row 6", "bfloat16"): ("drop_bwd_dq_mma_kernel", "drop_bwd_dkv_mma_kernel"),
    ("row 6", "float32"): ("drop_bwd_dq_kernel", "drop_bwd_dkv_kernel"),
}
# fp32 parameter gradients of a 2-layer model, card against CPU: summation
# order through two blocks, relative to the largest reference gradient.
MODEL_GRAD_TOL = 1e-4
# Served logits (magnitude ~1) against the CPU fp32 run of the same weights:
# fp32 differs by summation order through 12 layers; bf16 rounds every
# activation and weight (8 significant bits), so it is held to 5% of the
# largest reference logit.
LOGIT_TOL_FP32 = 1e-3
LOGIT_TOL_BF16_REL = 5e-2
# Swin logits of an fp32 model on the card against the CPU run: summation
# order through 12 blocks on logits of magnitude ~1.
SWIN_LOGIT_TOL_FP32 = 1e-4
# The single-pass Adam kernel against its plain version after 3 steps: both
# round every operation to fp32 in the same order.
ADAM_TOL = 1e-6
# Window kernel launches per forward that the routing of ops/windows.py
# implies for the 12 blocks of each preset (every other counter stays 0).
SWIN_LAUNCHES_PER_FORWARD = {
    "swint_224_imagenet": {"window_batched_attention": 4,
                           "window_fused_slab_attention": 1,
                           "window_fused_flat_attention": 7},
    "swinv2t_224_imagenet": {"window_batched_attention": 4,
                             "window_packed_attention": 8},
}


# Twins-SVT-S @224: 9 LSA blocks (stages 1, 2, 4 batched: 64, 16 and 1
# windows; stage 3's 4 windows fused flat, 14 % 8 != 0) and 9 GSA blocks
# (split-head kernel); PVT-Tiny: 8 SRA blocks.
HIER_LAUNCHES_PER_FORWARD = {
    "pvt_tiny224_imagenet": {"flash_attention": 8},
    "twins_svts224_imagenet": {"flash_attention": 9,
                               "window_batched_attention": 4,
                               "window_fused_flat_attention": 5},
}
TWINS_ROUTES = (["batched", "batched"] + ["fused_flat"] * 5
                + ["batched"] * 2)

# DETR-R50 outputs of an fp32 model on the card against the CPU run of the
# same weights: summation order through 53 convolutions and 9 attention
# layers; logits held relative to their largest magnitude, boxes (sigmoid
# outputs in [0, 1]) absolutely.
DETR_LOGIT_TOL_REL = 1e-3
DETR_BOX_TOL = 1e-3
# fp32 parameter gradients of the narrow DETR, card against CPU, relative to
# the largest reference gradient (21): the two devices sum the convolutions
# in different orders through 53 layers of random weights, and a
# pre-activation within rounding of 0 can fall on either side of a ReLU,
# which moves a whole gradient term. Measured on an H100 80GB HBM3: 2.0e-3
# (9.6e-5 of max|ref|) in layer4_block2.conv1.weight; of the 81 920
# pre-activations of the ReLU after it, 2 (CPU) and 1 (card) lie within
# 1e-6·max|z| of 0 and 1 falls on opposite sides on the two devices, and
# that weight gradient recomputed on the card with the CPU's ReLU mask is
# 2.1e-7 (9.9e-9 relative) from the CPU's. narrow_detr_gradients prints
# these counts each run and requires the masked recompute within
# RELU_MASK_TOL.
DETR_GRAD_TOL = 5e-4
RELU_MASK_TOL = 1e-4
# Launches per DETR-R50 forward at eval (6 encoder self and 6 decoder cross
# attentions take the streaming kernel with their key-padding mask; the
# mask-free 100 x 100 decoder self attention the split-head kernel), and
# per train step at dropout 0.1 and at dropout 0 under USE_PALLAS_BWD.
DETR_EVAL_LAUNCHES = {"flash_attention_large": 12, "flash_attention": 6}
DETR_TRAIN_LAUNCHES = {
    0.1: {"dropout_attention_fwd": 18, "dropout_attention_bwd": 18},
    0.0: {"flash_attention_large": 12, "flash_attention": 6,
          "flash_attention_bwd": 6, "dropout_attention_bwd": 12},
}
# The ViT family on the USE_FUSED_BLOCK path, @224: (class name, kwargs, the
# converter in utils/port_jax.py, encoder layers = fused launches per
# forward, other attention launches per forward). DeiT-B: Touvron et al.
# 2021 (arXiv:2012.12877); T2T-ViT-14 and T2T-ViT_t-14: Yuan et al. 2021
# (arXiv:2101.11986) Table 1, whose token transformer takes the streaming
# kernel at 3136 tokens and the split-head kernel at 784.
_T2T14 = dict(image_size=224, patch_size=16, num_layers=14, num_heads=6,
              hidden_dim=384, mlp_dim=1152, num_classes=1000, token_dim=64)
FAMILY_CONFIGS = {
    "vitb16_224_imagenet": ("ViT", None, "vit_state_dict_from_jax", 12, {}),
    "deit-b@224": ("DeiT", dict(image_size=224, patch_size=16, num_layers=12,
                                num_heads=12, embed_dim=768,
                                num_classes=1000),
                   "deit_state_dict_from_jax", 12, {}),
    "cpe-vit-b@224": ("CPEViT", None, "cpevit_state_dict_from_jax", 12, {}),
    "t2t-vit-14@224": ("T2T_ViT", _T2T14, "t2t_state_dict_from_jax", 14, {}),
    "t2t-vit_t-14@224": ("T2T_ViT", dict(_T2T14, token_type="transformer"),
                         "t2t_state_dict_from_jax", 14,
                         {"flash_attention_large": 1, "flash_attention": 1}),
}
# Four COCO-sized images (shorter side 800 or less, longer up to 1333): one
# batch at the 896 x 1344 bucket, each with its own padding.
COCO_SIZES = [(800, 1333), (800, 1199), (800, 1066), (752, 1333)]


class SyntheticCoco:
    """Map-style detection dataset: (H, W, 3) float images as DETR's
    transforms leave them (normalised, so N(0, 1) here) and targets with 1-6
    boxes (rel-cxcywh), labels in [1, 90], ``image_id`` and ``orig_size``,
    all drawn from ``seed``."""

    def __init__(self, sizes, seed):
        rng = np.random.RandomState(seed)
        self.items = []
        for i, (h, w) in enumerate(sizes):
            k = 1 + rng.randint(6)
            boxes = np.concatenate([rng.rand(k, 2) * 0.6 + 0.2,
                                    rng.rand(k, 2) * 0.3 + 0.05], axis=1)
            self.items.append((
                rng.standard_normal((h, w, 3)).astype(np.float32),
                {"labels": rng.randint(1, 91, k),
                 "boxes": boxes.astype(np.float32),
                 "image_id": np.asarray([i]),
                 "orig_size": np.asarray([h, w])}))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def jax_shaped_weights(model, seed: int):
    """The model's parameters as the JAX package's params tree holds them —
    nested dicts of numpy arrays, conv kernels (kh, kw, in, out), Dense
    kernels (in, out), norm scales named ``scale`` — drawn from one numpy
    stream: kernels N(0, 1/fan_in), scales 1 + N(0, 0.1), FrozenBN
    variances 1 + |N(0, 0.1)|, query embeddings N(0, 1), the rest
    N(0, 0.02)."""
    rng = np.random.RandomState(seed)
    tree = {}
    for name, p in model.state_dict().items():
        *path, leaf = name.split(".")
        shape = tuple(p.shape)
        if leaf == "weight" and len(shape) == 4:
            leaf, shape = "kernel", shape[2:] + (shape[1], shape[0])
        elif leaf == "weight" and len(shape) == 2:
            leaf, shape = "kernel", shape[::-1]
        elif leaf == "weight":
            leaf = "scale"
        if leaf == "kernel":
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif leaf == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf == "var":
            a = 1.0 + 0.1 * np.abs(rng.standard_normal(shape))
        elif leaf == "query_embed":
            a = rng.standard_normal(shape)
        else:
            a = 0.02 * rng.standard_normal(shape)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = a.astype(np.float32)
    return tree


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def seeded_state_dict(model, seed: int):
    """Every parameter from one numpy stream: Dense weights with xavier
    scale, LayerNorm scales 1 + N(0, 0.1), SwinV2's ``logit_scale``
    log 10 + N(0, 0.1), Twins' depthwise conv kernels N(0, 1/9),
    everything else N(0, 0.02)."""
    import torch

    rng = np.random.RandomState(seed)
    out = {}
    for name, p in model.state_dict().items():
        shape = tuple(p.shape)
        if name.endswith("logit_scale"):  # SwinV2's temperature, init log 10
            a = np.log(10.0) + 0.1 * rng.standard_normal(shape)
        elif name.endswith("weight") and len(shape) == 2:
            a = rng.standard_normal(shape) * (2.0 / sum(shape)) ** 0.5
        elif name.endswith("weight") and len(shape) == 4:  # depthwise 3x3
            a = rng.standard_normal(shape) / 3.0
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


def kernel_names(fn):
    """Names of the CUDA kernels that one call of ``fn`` launches, from
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def require_route(label, fn, routes):
    """One call of ``fn`` launches, for each (row, dtype) of ``routes``, the
    kernels of ROUTE_NAMES[(row, dtype)] and none of that row's other
    route."""
    names = kernel_names(fn)
    require(bool(names), f"{label}: the profiler saw the card's kernels")
    hit = lambda s: any(s in n for n in names)  # noqa: E731
    for row, dtype in routes:
        other = "float32" if dtype == "bfloat16" else "bfloat16"
        new, old = ROUTE_NAMES[(row, dtype)], ROUTE_NAMES[(row, other)]
        require(all(hit(s) for s in new) and not any(hit(s) for s in old),
                f"{label}: {row} in {dtype} launches {new}, none of {old}")
        log(f"route {label}: {row} {dtype} through {', '.join(new)}")


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


def dense_chain_weights(randn, dtype):
    """The weights of benchmarks/ln_fused.py's ViT-B/16 layer (D 768, MLP
    3072): LN scale and shift, QKV, out, fc1 and fc2 kernels (in, out) and
    their biases; fp32 rows, kernels in ``dtype``."""
    import torch

    d, mlp = 768, 3072
    f32 = torch.float32
    ones = torch.ones(d, device="cuda")
    zeros = lambda n: torch.zeros(n, device="cuda")  # noqa: E731
    kernel = lambda seed, k, n: (0.02 * randn(seed, k, n, dtype=f32)).to(  # noqa: E731
        dtype)
    return dict(gamma=ones, beta=zeros(d), wqkv=kernel(141, d, 3 * d),
                bqkv=zeros(3 * d), wout=kernel(142, d, d), bout=zeros(d),
                w1=kernel(143, d, mlp), b1=zeros(mlp), w2=kernel(144, mlp, d),
                b2=zeros(d))


def base_ln_dense(x, gamma, beta, w, bias=None, *, eps=1e-6, activation=None):
    """``ln_dense`` from library calls: ``F.layer_norm`` → ``F.linear``
    (+ ``F.gelu``), in x's dtype (the ln_fused benchmark's "base" layer)."""
    import torch.nn.functional as F

    xn = F.layer_norm(x, (x.shape[-1],), gamma.to(x.dtype), beta.to(x.dtype),
                      eps)
    y = F.linear(xn, w.t(), None if bias is None else bias.to(x.dtype))
    if activation is not None:
        y = F.gelu(y, approximate="tanh" if activation == "gelu_tanh"
                   else "none")
    return y


def ln_fused_chain(x, c, dense, attention, layers=12, heads=12):
    """benchmarks/ln_fused.py's layer, ``layers`` times: x + out(attn(
    dense(ln_1, QKV))); x + fc2(dense(ln_2, fc1, GELU))."""
    import torch.nn.functional as F

    for _ in range(layers):
        y = attention(dense(x, c["gamma"], c["beta"], c["wqkv"], c["bqkv"]),
                      heads)
        x = x + F.linear(y, c["wout"].t(), c["bout"].to(x.dtype))
        y = dense(x, c["gamma"], c["beta"], c["w1"], c["b1"],
                  activation="gelu_tanh")
        x = x + F.linear(y, c["w2"].t(), c["b2"].to(x.dtype))
    return x


def narrow_detr_gradients():
    """fp32 parameter gradients of a narrow DETR (hidden 32, 1 + 2 layers,
    full ResNet-50, two images at 128 x 160) on the CPU and on the card from
    the same weights, held to ``DETR_GRAD_TOL``; then the diagnosis of the
    ReLU after ``layer4_block2.conv1`` (see ``relu_mask_diagnosis``). Returns
    the card run's kernel launches."""
    import torch

    from vision_transformers_tpu_torch.models.object_detection import (
        Detr,
        HungarianMatcher,
        SetCriterion,
        prepare_targets,
    )
    from vision_transformers_tpu_torch.ops import flash_attention as fa
    from vision_transformers_tpu_torch.utils.coco.util.misc import (
        nested_tensor_from_tensor_list,
    )
    from vision_transformers_tpu_torch.utils.port_jax import (
        detr_state_dict_from_jax,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    narrow = dict(num_classes=91, hidden_dim=32, nheads=2,
                  num_encoder_layers=1, num_decoder_layers=2,
                  dim_feedforward=64, dropout=0.0, aux_loss=True)
    nds = SyntheticCoco([(128, 150), (100, 160)], seed=16)
    ntn = nested_tensor_from_tensor_list([nds[i][0] for i in range(2)],
                                         size_bucket=32)
    require(ntn.tensors.shape == (2, 128, 160, 3), "narrow batch 128 x 160")
    ncrit = SetCriterion(num_classes=91,
                         matcher=HungarianMatcher(method="scipy"))
    nweights, launches = None, None
    grads, taps = {}, {}
    fa.USE_PALLAS_BWD = True
    for device in ("cpu", "cuda"):
        m = Detr(**narrow, device=device)
        if nweights is None:
            nweights = detr_state_dict_from_jax(jax_shaped_weights(m, 17))
        m.load_state_dict(nweights, strict=True)
        m.train()
        taps[device] = tap_relu_after_conv1(
            m.get_submodule("joiner.backbone.layer4_block2"))
        fa.reset_launch_counts()
        b = ntn.to(device)
        labels, boxes, valid = prepare_targets([nds[i][1] for i in range(2)],
                                               64, 91, device)
        loss = ncrit.total_loss(ncrit(m(b.tensors, b.mask), labels, boxes,
                                      valid))
        loss.backward()
        grads[device] = (loss.item(), {n: p.grad.detach().cpu()
                                       for n, p in m.named_parameters()
                                       if p.grad is not None})
        if device == "cuda":
            launches = {k: v for k, v in fa.LAUNCHES.items() if v}
            require(launches == {"flash_attention_large": 3,
                                 "flash_attention": 2,
                                 "flash_attention_bwd": 2,
                                 "dropout_attention_bwd": 3},
                    f"narrow DETR gradients went through rows 3, 2, 4, 6; "
                    f"got {launches}")
    fa.USE_PALLAS_BWD = False
    g_ref = max(g.abs().max().item() for g in grads["cpu"][1].values())
    require(set(grads["cpu"][1]) == set(grads["cuda"][1]),
            "the same parameters take gradients on both devices")
    e_grad, worst = max((max_err(grads["cuda"][1][n], g), n)
                        for n, g in grads["cpu"][1].items())
    log(f"fp32 gradients of a narrow DETR (hidden 32, 1 + 2 layers, "
        f"ResNet-50, 128 x 160), card vs CPU: loss {grads['cuda'][0]:.6f} vs "
        f"{grads['cpu'][0]:.6f}, max|dgrad| {e_grad:.3e} over "
        f"{len(grads['cpu'][1])} tensors, at {worst} (its max|ref| "
        f"{grads['cpu'][1][worst].abs().max().item():.3e}; max|ref| "
        f"{g_ref:.3e}, tol {DETR_GRAD_TOL} x max(1, max|ref|))")
    diag = relu_mask_diagnosis(
        taps, grads["cpu"][1]["joiner.backbone.layer4_block2.conv1.weight"],
        grads["cuda"][1]["joiner.backbone.layer4_block2.conv1.weight"], g_ref)
    require(diag["CPU mask, card dy"] <= RELU_MASK_TOL * max(1.0, g_ref),
            "layer4_block2.conv1's gradient with the CPU's ReLU mask matches "
            "the CPU's: the gap is the ReLU's flipped pre-activations")
    require(abs(grads["cuda"][0] - grads["cpu"][0])
            <= 1e-4 * max(1.0, abs(grads["cpu"][0]))
            and e_grad <= DETR_GRAD_TOL * max(1.0, g_ref),
            "narrow DETR gradients on the card against the CPU")
    return launches


def tap_relu_after_conv1(block):
    """Hooks on a ResNet bottleneck that keep, from one forward and
    backward: conv1's input x, the pre-activation z = bn1(conv1(x)) of the
    first ReLU, the gradient dy arriving at that ReLU's output (conv2's
    input) and bn1's per-channel scale."""
    import torch

    tap = {}

    def keep_dy(_, args):
        args[0].register_hook(lambda g: tap.__setitem__("dy", g.detach()))

    block.conv1.register_forward_pre_hook(
        lambda _, args: tap.__setitem__("x", args[0].detach()))
    block.bn1.register_forward_hook(
        lambda _, args, out: tap.__setitem__("z", out.detach()))
    block.conv2.register_forward_pre_hook(keep_dy)
    bn = block.bn1
    tap["inv"] = (bn.weight * torch.rsqrt(bn.var + bn.epsilon)).detach()
    tap["w_shape"] = block.conv1.weight.shape
    return tap


def relu_mask_diagnosis(taps, grad_cpu, grad_card, g_ref):
    """The hypothesis for the card-vs-CPU gradient gap of
    ``layer4_block2.conv1.weight``: pre-activations within fp32 rounding of
    0 take opposite sides of the ReLU on the two devices. Counts them, then
    recomputes that weight gradient on the card from the card's x and dy
    with each device's ReLU mask (and, to attribute the rest, with the
    CPU's dy), against the CPU's gradient. Logs and returns the numbers."""
    import torch

    cpu, card = taps["cpu"], taps["cuda"]
    z_cpu, z_card = cpu["z"], card["z"].cpu()
    near = {d: int((t["z"].abs() <= 1e-6 * t["z"].abs().max()).sum().item())
            for d, t in taps.items()}
    flips = int(((z_cpu > 0) != (z_card > 0)).sum().item())
    dev = card["x"].device

    def weight_grad(mask, dy):
        """d loss / d conv1.weight of a 1x1 conv: Σ x ⊗ (dy·mask·inv)."""
        dz = (dy.to(dev) * mask.to(dev) * card["inv"]).permute(0, 3, 1, 2)
        return torch.nn.grad.conv2d_weight(card["x"].permute(0, 3, 1, 2),
                                           card["w_shape"], dz).cpu()

    mask_cpu, mask_card = z_cpu > 0, z_card > 0
    rows = {
        "card mask, card dy (autograd's)": weight_grad(mask_card, card["dy"]),
        "CPU mask, card dy": weight_grad(mask_cpu, card["dy"]),
        "card mask, CPU dy": weight_grad(mask_card, cpu["dy"]),
        "CPU mask, CPU dy": weight_grad(mask_cpu, cpu["dy"]),
    }
    out = {"near_zero_cpu": near["cpu"], "near_zero_card": near["cuda"],
           "opposite_signs": flips, "elements": z_cpu.numel(),
           "autograd_gap": max_err(grad_card, grad_cpu),
           "recompute_vs_autograd": max_err(
               rows["card mask, card dy (autograd's)"], grad_card),
           "dy_diff": max_err(card["dy"].cpu(), cpu["dy"]),
           "g_ref": g_ref}
    log(f"layer4_block2 ReLU after conv1: {z_cpu.numel()} pre-activations, "
        f"{near['cpu']} (CPU) / {near['cuda']} (card) within 1e-6 x max|z| of "
        f"0, {flips} on opposite sides of 0 on the two devices; "
        f"max|dy card - dy CPU| {out['dy_diff']:.3e}")
    log(f"  conv1.weight gradient, card autograd vs CPU: "
        f"{out['autograd_gap']:.3e} ({out['autograd_gap'] / g_ref:.2e} of "
        f"max|ref| {g_ref:.3e}); the recompute vs card autograd "
        f"{out['recompute_vs_autograd']:.3e}")
    for label, g in rows.items():
        e = max_err(g, grad_cpu)
        out[label] = e
        log(f"  recomputed on the card with {label}: vs CPU {e:.3e} "
            f"({e / g_ref:.2e} relative)")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    import torch.nn.functional as F

    from vision_transformers_tpu_torch import serving
    from vision_transformers_tpu_torch.models.image_classification import (
        PVT,
        SwinTransformer,
        SwinTransformerV2,
        TwinSVT,
        ViT,
    )
    from vision_transformers_tpu_torch.ops import _build
    from vision_transformers_tpu_torch.ops import flash_attention as fa
    from vision_transformers_tpu_torch.ops import fused_adam as fadam
    from vision_transformers_tpu_torch.ops import fused_dense as fdense
    from vision_transformers_tpu_torch.ops import windows
    from vision_transformers_tpu_torch.training import trainer
    from vision_transformers_tpu_torch.training.optimizers import make_optimizer
    from vision_transformers_tpu_torch.models.object_detection import (
        Detr,
        HungarianMatcher,
        SetCriterion,
        prepare_targets,
    )
    from vision_transformers_tpu_torch.models.object_detection.matcher import (
        _host_assign,
        auction_assign,
    )
    from vision_transformers_tpu_torch.ops import attention as attn
    from vision_transformers_tpu_torch.training.detection import (
        DetectionLoader,
        evaluate_model,
        fit_detection,
    )
    from vision_transformers_tpu_torch.utils.args import get_args
    from vision_transformers_tpu_torch.utils.coco.util.misc import (
        nested_tensor_from_tensor_list,
    )
    from vision_transformers_tpu_torch.utils.port_jax import (
        detr_state_dict_from_jax,
    )

    import vision_transformers_tpu_torch.models.image_classification as zoo
    from vision_transformers_tpu_torch.models.image_classification import (
        vanilla_vit as vv,
    )
    from vision_transformers_tpu_torch.utils import port_jax

    # ViT-B/16 widths for the ViT and CPE-ViT entries
    vitb = get_args("vitb16_224_imagenet")
    FAMILY = {label: (getattr(zoo, cls), kw if kw is not None else vitb,
                      convert, layers, extra)
              for label, (cls, kw, convert, layers, extra)
              in FAMILY_CONFIGS.items()}

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


    # the four window kernels: Swin-T and SwinV2-T stage shapes at batch 32,
    # and swin_tiny_cifar's 4x4 window
    def window_inputs(g, n, h, dh, nwp, dtype):
        qkv = randn(30, g, n, 3 * h * dh, dtype=dtype)
        bias = None if nwp == 0 else randn(31, nwp, h, n, n, dtype=fp32)
        return qkv, bias

    def check_window(label, g, n, h, dh, nwp, dtype):
        name = str(dtype).removeprefix("torch.")
        qkv, bias = window_inputs(g, n, h, dh, nwp, dtype)
        ref = fa.window_attention_reference(qkv, bias, h)
        for fn in ("window_packed_attention", "window_batched_attention"):
            out = getattr(fa, fn)(qkv, bias, h)
            torch.cuda.synchronize()
            e = max_err(out, ref)
            log(f"{fn} {label} {name}: max|out-plain| {e:.3e} "
                f"(tol {WINDOW_TOL[name]})")
            require(bool(torch.isfinite(out.float()).all())
                    and e <= WINDOW_TOL[name],
                    f"{fn} {label} {name} against its plain version")
            errs[(fn, label, name)] = e

    def fused_inputs(b, hw, win, h, dh, per_window, dtype):
        n = win * win
        nwp = (hw // win) ** 2 if per_window else 1
        return (randn(32, b, hw, hw, 3 * h * dh, dtype=dtype),
                randn(33, nwp, h, n, n, dtype=fp32), nwp)

    def fused_plans(b, hw, win, h, dh, nwp):
        """The plans a map has: flat always, slab where wp % 8 == 0."""
        geom = (b, hw, hw, win, win, h, dh, nwp)
        plans = {"slab": fa.window_fused_plan(*geom),
                 "flat": fa.window_fused_flat_plan(*geom)}
        return {k: p for k, p in plans.items() if p is not None}

    def check_fused(label, b, hw, win, shift, h, dh, dtype):
        name = str(dtype).removeprefix("torch.")
        qkv, bias, nwp = fused_inputs(b, hw, win, h, dh, shift > 0, dtype)
        ref = fa.window_fused_reference(qkv, bias, h, (win, win),
                                        (shift, shift))
        outs = {}
        for kind, plan in fused_plans(b, hw, win, h, dh, nwp).items():
            out = torch.full((b, hw, hw, h * dh), float("nan"), device=dev,
                             dtype=dtype)
            fa.fused_window_attention(qkv, bias, h, (win, win),
                                      (shift, shift), plan=plan, out=out)
            torch.cuda.synchronize()
            require(not bool(torch.isnan(out.float()).any()),
                    f"fused {kind} {label} {name}: every output element is "
                    "written (none of the NaN fill is left)")
            e = max_err(out, ref)
            log(f"window_fused_{kind}_attention {label} shift {shift} {name}: "
                f"max|out-plain| {e:.3e} (tol {WINDOW_TOL[name]}), no NaN "
                "left of the fill")
            require(e <= WINDOW_TOL[name],
                    f"fused {kind} {label} {name} against its plain version")
            errs[(f"window_fused_{kind}_attention", label, shift, name)] = e
            outs[kind] = out
        if len(outs) == 2:
            e = max_err(outs["slab"], outs["flat"])
            log(f"  slab against flat on the same map: max|diff| {e:.3e}")
            require(e <= WINDOW_TOL[name],
                    f"slab against flat, {label} {name}")

    for dtype in (bf16, fp32):
        check_window("swin-t s1 G2048 N49 H3 shared", 2048, 49, 3, 32, 1, dtype)
        check_window("swin-t s1 G2048 N49 H3 nW'64", 2048, 49, 3, 32, 64, dtype)
        check_window("swin-t s2 G512 N49 H6 nW'16", 512, 49, 6, 32, 16, dtype)
        check_window("swin-t s3 G128 N49 H12 nW'4", 128, 49, 12, 32, 4, dtype)
        check_window("swin-t s4 G32 N49 H24 shared", 32, 49, 24, 32, 1, dtype)
        check_window("swinv2-t s1 G1568 N64 H3 nW'49", 1568, 64, 3, 32, 49,
                     dtype)
        check_window("cifar G1024 N16 H3 nW'16", 1024, 16, 3, 32, 16, dtype)
        check_window("no bias G33 N49 H3", 33, 49, 3, 32, 0, dtype)
        for shift in (3, 0):
            check_fused("swin-t s1 B32 56x56 H3", 32, 56, 7, shift, 3, 32,
                        dtype)
            check_fused("swin-t s2 B32 28x28 H6", 32, 28, 7, shift, 6, 32,
                        dtype)
            check_fused("swin-t s3 B32 14x14 H12", 32, 14, 7, shift, 12, 32,
                        dtype)
        check_fused("swinv2-t s2 B32 32x32 win8 H6", 32, 32, 8, 4, 6, 32,
                    dtype)
        check_fused("cifar B64 16x16 win4 H3", 64, 16, 4, 2, 3, 32, dtype)

    # the window backward kernel (the four forward kernels share it)
    def check_window_bwd(label, g, n, h, dh, nwp, dtype):
        name = str(dtype).removeprefix("torch.")
        qkv, bias = window_inputs(g, n, h, dh, nwp, dtype)
        do = randn(34, g, n, h * dh, dtype=dtype)
        ref, ref_db = fa.window_attention_bwd_reference(qkv, bias, do, h)
        filled = torch.full_like(qkv, float("nan"))
        got, got_db = fa.window_attention_bwd(qkv, bias, do, h, dqkv=filled)
        again, again_db = fa.window_attention_bwd(qkv, bias, do, h)
        torch.cuda.synchronize()
        what = f"window_attention_bwd {label} {name}"
        require(got is filled and not bool(torch.isnan(got.float()).any()),
                f"{what}: every element of dqkv is written (none of the NaN "
                "fill is left)")
        e, tol = grad_err(f"{what} dqkv", got, ref, name)
        require(torch.equal(got, again), f"{what}: two runs give equal dqkv")
        msg = f"{what}: max|dqkv-plain| {e:.3e} (tol {tol:.3e})"
        errs[("window_attention_bwd", label, name)] = e
        if bias is None:
            require(got_db is None, f"{what}: no bias, no dbias")
        else:
            # relative to its own scale: it sums G/nW' windows
            eb, tolb = grad_err(f"{what} dbias", got_db, ref_db, name)
            require(got_db.dtype == bias.dtype and got_db.shape == bias.shape
                    and torch.equal(got_db, again_db),
                    f"{what}: dbias as the bias, equal from run to run")
            lean, none = fa.window_attention_bwd(qkv, bias, do, h,
                                                 need_dbias=False)
            require(none is None and torch.equal(lean, got),
                    f"{what}: the same dqkv without the bias gradient")
            msg += f", max|dbias-plain| {eb:.3e} (tol {tolb:.3e})"
        if dtype == fp32:  # the second oracle: autograd of the plain forward
            leaves = [qkv.clone().requires_grad_()] + (
                [] if bias is None else [bias.clone().requires_grad_()])
            auto = torch.autograd.grad(fa.window_attention_reference(
                leaves[0], None if bias is None else leaves[1], h), leaves, do)
            ea = max(grad_err(f"{what} against autograd", a, b, name)[0]
                     for a, b in zip([got, got_db], auto))
            msg += f", against autograd of the plain forward {ea:.3e}"
        log(msg + ", NaN fill overwritten, rerun bit-equal")

    def check_fused_grad(label, b, hw, win, shift, h, dh):
        """fp32 gradients through the fused wrappers' autograd function
        against autograd of their plain version."""
        qkv, bias, nwp = fused_inputs(b, hw, win, h, dh, shift > 0, fp32)
        do = randn(35, b, hw, hw, h * dh, dtype=fp32)
        window, sh = (win, win), (shift, shift)
        x, bb = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
        ref = torch.autograd.grad(
            fa.window_fused_reference(x, bb, h, window, sh), (x, bb), do)
        for kind, plan in fused_plans(b, hw, win, h, dh, nwp).items():
            x, bb = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
            before = fa.LAUNCHES["window_attention_bwd"]
            got = torch.autograd.grad(fa.fused_window_attention(
                x, bb, h, window, sh, plan=plan), (x, bb), do)
            require(fa.LAUNCHES["window_attention_bwd"] == before + 1,
                    f"fused {kind} {label}: its backward launches the kernel")
            e = max(grad_err(f"fused {kind} {label} shift {shift} gradient",
                             a, r, "float32")[0] for a, r in zip(got, ref))
            log(f"fused_window_attention ({kind}) {label} shift {shift} fp32: "
                f"max|grad - autograd of plain| {e:.3e} (d map and dbias)")

    for dtype in (bf16, fp32):
        check_window_bwd("swin-t s1 G2048 N49 H3 shared", 2048, 49, 3, 32, 1,
                         dtype)
        check_window_bwd("swin-t s1 G2048 N49 H3 nW'64", 2048, 49, 3, 32, 64,
                         dtype)
        check_window_bwd("swin-t s2 G512 N49 H6 nW'16", 512, 49, 6, 32, 16,
                         dtype)
        check_window_bwd("swin-t s3 G128 N49 H12 nW'4", 128, 49, 12, 32, 4,
                         dtype)
        check_window_bwd("swin-t s4 G32 N49 H24 shared", 32, 49, 24, 32, 1,
                         dtype)
        check_window_bwd("swinv2-t s1 G1568 N64 H3 nW'49", 1568, 64, 3, 32,
                         49, dtype)
        check_window_bwd("cifar G1024 N16 H3 nW'16", 1024, 16, 3, 32, 16,
                         dtype)
        check_window_bwd("no bias G33 N49 H3", 33, 49, 3, 32, 0, dtype)
        check_window_bwd("dh16 G8 N49 H2 shared", 8, 49, 2, 16, 1, dtype)
        check_window_bwd("dh64 G8 N49 H2 nW'4", 8, 49, 2, 64, 4, dtype)
    for shift in (3, 0):
        check_fused_grad("swin-t s1 B8 56x56 H3", 8, 56, 7, shift, 3, 32)
        check_fused_grad("swin-t s2 B8 28x28 H6", 8, 28, 7, shift, 6, 32)

    # the single-pass Adam kernel: leaves on both sides of 65 536 elements,
    # one with a ragged last vector, 3 steps, with and without weight decay
    adam_shapes = [(300, 300), (65536,), (65539,), (768, 3072), (1000,),
                   (7, 9)]
    n_large = sum(int(np.prod(sh_)) >= fadam._MIN_FUSED_SIZE
                  for sh_ in adam_shapes)
    for wd in (0.0, 0.05):
        leaves = [[randn(36 + i, *sh_, dtype=fp32) * sc
                   for i, sh_ in enumerate(adam_shapes)]
                  for sc in (1.0, 0.0, 0.0)]
        oracle = [[t.clone() for t in group] for group in leaves]
        ptrs = [t.data_ptr() for group in leaves for t in group]
        fa.reset_launch_counts()
        for t_step in range(1, 4):
            grads = [randn(50 + 10 * t_step + i, *sh_, dtype=fp32)
                     for i, sh_ in enumerate(adam_shapes)]
            fadam.fused_adam_update(*leaves, grads, t_step, 1e-3,
                                    weight_decay=wd)
            sc = fadam.adam_scalars(t_step, 1e-3, weight_decay=wd)
            for leaf in zip(*oracle, grads):
                fadam.fused_adam_reference(*leaf, sc)
        torch.cuda.synchronize()
        e = max(max_err(a, r) for got, want in zip(leaves, oracle)
                for a, r in zip(got, want))
        log(f"fused_adam weight decay {wd}: 3 steps over {len(adam_shapes)} "
            f"leaves ({n_large} through the kernel), max|p, m, v - plain| "
            f"{e:.3e} (tol {ADAM_TOL}), in place")
        require(e <= ADAM_TOL, "fused_adam against its plain version")
        require(fa.LAUNCHES["fused_adam"] == 3 * n_large,
                "fused_adam: one launch per large leaf and step")
        require(ptrs == [t.data_ptr() for group in leaves for t in group],
                "fused_adam updates p, m and v in place")
        errs[("fused_adam", wd)] = e
    del leaves, oracle, grads

    # the streaming forward (row 3): the DETR-R50 encoder and cross shapes
    # at the 896 x 1344 bucket, with the key masks the Joiner makes for the
    # four COCO sizes, and a bias-free, mask-free ViT-B shape at S 1297
    def coco_keep(sizes, hp=896, wp=1344, stride=16):
        """(B, Hp/16 · Wp/16) keep-mask of the C5 tokens, resized as the
        Joiner resizes the pixel mask."""
        pix = torch.ones(len(sizes), 1, hp, wp)
        for i, (h, w) in enumerate(sizes):
            pix[i, 0, :h, :w] = 0.0
        c5 = F.interpolate(pix, size=(hp // stride, wp // stride),
                           mode="nearest-exact")[:, 0]
        return (c5 == 0).reshape(len(sizes), -1).to(dev)

    det_keep = coco_keep(COCO_SIZES)
    log(f"DETR C5 key masks at 896 x 1344: unmasked tokens per image "
        f"{det_keep.sum(dim=1).tolist()} of {det_keep.shape[1]}")

    def check_large(label, b, h, sq, sk, d, kv_valid, keep, dtype):
        name = str(dtype).removeprefix("torch.")
        q = randn(70, b, h, sq, d, dtype=dtype)
        k = randn(71, b, h, sk, d, dtype=dtype)
        v = randn(72, b, h, sk, d, dtype=dtype)
        filled = torch.full_like(q, float("nan"))
        out, lse = fa.flash_attention_large_fwd(q, k, v, kv_mask=keep,
                                                kv_valid=kv_valid, out=filled)
        e = el = 0.0
        for i in range(b):  # the plain version one image at a time
            ref, ref_lse = fa.flash_attention_large_reference(
                q[i:i + 1], k[i:i + 1], v[i:i + 1], kv_valid=kv_valid,
                kv_mask=None if keep is None else keep[i:i + 1])
            e = max(e, max_err(out[i:i + 1], ref))
            el = max(el, max_err(lse[i:i + 1], ref_lse))
        again, _ = fa.flash_attention_large_fwd(q, k, v, kv_mask=keep,
                                                kv_valid=kv_valid)
        torch.cuda.synchronize()
        log(f"flash_attention_large {label} {name}: max|out-plain| {e:.3e} "
            f"(tol {KERNEL_TOL[name]}), max|lse-plain| {el:.3e}, NaN fill "
            "overwritten, rerun bit-equal")
        require(not bool(torch.isnan(out.float()).any())
                and e <= KERNEL_TOL[name] and el <= LSE_TOL
                and torch.equal(out, again),
                f"flash_attention_large {label} {name} against its plain "
                "version")
        errs[("large", label, name)] = e

    for dtype in (bf16, fp32):
        check_large("detr-r50 encoder B4 G32 S4704 D32", 4, 8, 4704, 4704,
                    32, None, det_keep, dtype)
        check_large("detr-r50 cross B4 Sq100 Sk4704 D32", 4, 8, 100, 4704,
                    32, None, det_keep, dtype)
        check_large("vitb16@576 B2 G24 S1297 D64 no mask", 2, 12, 1297, 1297,
                    64, None, None, dtype)
        check_large("kv_valid 4600/4704 + mask", 2, 8, 300, 4704, 32, 4600,
                    det_keep[:2], dtype)
    # an image whose keys are all masked: the uniform average over its keys
    keep = det_keep[:3, :300].clone()
    keep[1] = False
    qm, km, vm = (randn(73 + i, 3, 2, 300, 32, dtype=fp32) for i in range(3))
    got, _ = fa.flash_attention_large_fwd(qm, km, vm, kv_mask=keep)
    want = attn.mha_reference(qm, km, vm, mask=keep[:, None, None, :])
    e_full = max_err(got, want)
    log(f"flash_attention_large fully masked image: max|out - mha_reference| "
        f"{e_full:.3e}")
    require(e_full <= KERNEL_TOL["float32"],
            "a fully masked image averages its keys, as mha_reference does")

    # the small-S backward (row 4) against its plain version, the row-6
    # kernel at rate 0 and, in fp32, autograd of the plain forward
    def check_small_bwd(label, b, h, s, d, kv_valid, dtype):
        name = str(dtype).removeprefix("torch.")
        q, k, v, do = (randn(75 + i, b, h, s, d, dtype=dtype)
                       for i in range(4))
        out, lse = fa.flash_attention_reference(q, k, v, kv_valid=kv_valid)
        filled = tuple(torch.full_like(t, float("nan")) for t in (q, k, v))
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, kv_valid=kv_valid,
                                     grads=filled)
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                kv_valid=kv_valid)
        row6 = fa.flash_dropout_attention_bwd(q, k, v, do, out, lse,
                                              dropout_rate=0.0, seed=None,
                                              kv_valid=kv_valid)
        e = max(grad_err(f"flash_attention_bwd {label} {name} d{n}", g, w,
                         name)[0] for n, g, w in zip("qkv", got, want))
        e6 = max(grad_err(f"flash_attention_bwd {label} {name} d{n} vs row 6",
                          g, w, name)[0] for n, g, w in zip("qkv", got, row6))
        extra = ""
        if dtype == fp32:
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            fa.flash_attention_reference(*leaves,
                                         kv_valid=kv_valid)[0].backward(do)
            ea = max(grad_err(f"flash_attention_bwd {label} d{n} vs autograd",
                              g, t.grad, name)[0]
                     for n, g, t in zip("qkv", got, leaves))
            extra = f", vs autograd of the plain forward {ea:.3e}"
        again = fa.flash_attention_bwd(q, k, v, out, lse, do,
                                       kv_valid=kv_valid)
        torch.cuda.synchronize()
        require(not any(bool(torch.isnan(g.float()).any()) for g in got)
                and all(torch.equal(a, g) for a, g in zip(again, got)),
                f"flash_attention_bwd {label} {name}: every element written, "
                "reruns bit-equal")
        log(f"flash_attention_bwd {label} {name}: max|grad-plain| {e:.3e}, vs "
            f"row 6 at rate 0 {e6:.3e}{extra} (tol {GRAD_TOL[name]} x max(1, "
            "max|ref|)), NaN fill overwritten, rerun bit-equal")
        errs[("small_bwd", label, name)] = e

    for dtype in (bf16, fp32):
        check_small_bwd("detr decoder self B2 G16 S100 D32", 2, 8, 100, 32,
                        None, dtype)
        check_small_bwd("vitb16@224 B32 G384 S197 D64", 32, 12, 197, 64, None,
                        dtype)
        check_small_bwd("kv_valid 90/100", 2, 8, 100, 32, 90, dtype)
    del qm, km, vm, got, want

    # rows 2 and 6: bf16 on the tensor-core kernels, fp32 on the CUDA-core
    # ones, by the kernels' names in a profile; then the bf16 kernels at the
    # paths' own shapes against their plain versions, reruns bit-equal
    for dtype in (bf16, fp32):
        name = str(dtype).removeprefix("torch.")
        q, k, v, do = (randn(80 + i, 2, 4, 150, 64, dtype=dtype)
                       for i in range(4))
        out, lse = fa.flash_attention_reference(q, k, v)
        require_route(f"wrappers {name}", lambda: (
            fa.flash_attention_fwd(q, k, v),
            fa.flash_dropout_attention_bwd(q, k, v, do, out, lse,
                                           dropout_rate=0.1, seed=5)),
            [("row 2", name), ("row 6", name)])

    def check_flash_path(label, b, h, s, d, bias_lead):
        q, k, v = (randn(84 + i, b, h, s, d, dtype=bf16) for i in range(3))
        bias = (None if bias_lead is None
                else randn(87, bias_lead, h, s, s, dtype=fp32))
        out, lse = fa.flash_attention_fwd(q, k, v, bias)
        ref, ref_lse = fa.flash_attention_reference(q, k, v, bias)
        again = fa.flash_attention_fwd(q, k, v, bias)
        torch.cuda.synchronize()
        e, el = max_err(out, ref), max_err(lse, ref_lse)
        require(bool(torch.isfinite(out.float()).all())
                and e <= KERNEL_TOL["bfloat16"] and el <= LSE_TOL
                and torch.equal(again[0], out) and torch.equal(again[1], lse),
                f"split {label} bf16 against its plain version, rerun "
                "bit-equal")
        log(f"split {label} bf16 (tensor cores): max|out-plain| {e:.3e} "
            f"(tol {KERNEL_TOL['bfloat16']}), max|lse-plain| {el:.3e}, "
            "rerun bit-equal")
        errs[("flash_path", label)] = e

    def check_drop_path(label, b, h, sq, sk, d, key_mask, rate):
        q, k, v, do = (randn(88 + i, b, h, n, d, dtype=bf16)
                       for i, n in enumerate((sq, sk, sk, sq)))
        kw = dict(dropout_rate=rate, seed=4321 + (11 << 34),
                  key_mask=key_mask)
        out, lse = fa.flash_dropout_attention_reference(q, k, v, **kw)
        got = fa.flash_dropout_attention_bwd(q, k, v, do, out, lse, **kw)
        want = fa.flash_dropout_attention_bwd_reference(q, k, v, do, out,
                                                        lse, **kw)
        again = fa.flash_dropout_attention_bwd(q, k, v, do, out, lse, **kw)
        torch.cuda.synchronize()
        e = 0.0
        for n, g, w in zip("qkv", got, want):
            scale_ = max(1.0, w.float().abs().max().item())
            e = max(e, max_err(g, w) / scale_)
            require(bool(torch.isfinite(g.float()).all())
                    and max_err(g, w) <= MMA_GRAD_TOL * scale_,
                    f"dropout bwd {label} bf16 d{n} against its plain version")
        require(all(torch.equal(a, g) for a, g in zip(again, got)),
                f"dropout bwd {label} bf16: reruns bit-equal")
        log(f"dropout bwd {label} bf16 rate {rate} (tensor cores, "
            f"{fa.dkv_chunks(b * h, sq, sk)} dk/dv chunks): max|grad-plain| "
            f"/ max(1, max|ref|) {e:.3e} (tol {MMA_GRAD_TOL}), rerun bit-equal")
        errs[("drop_path", label)] = e
        del q, k, v, do, out, lse, got, want, again

    check_flash_path("detr decoder self B4 G32 S100 D32", 4, 8, 100, 32, None)
    check_flash_path("detr decoder self B4 G32 S100 D32 + bias", 4, 8, 100,
                     32, 1)
    check_drop_path("detr encoder B2 G16 S4704 D32 + COCO key mask", 2, 8,
                    4704, 4704, 32, coco_keep(COCO_SIZES[:2]), 0.1)
    check_drop_path("pvt stage 1 B32 G32 Sq3136 Sk49 D64", 32, 1, 3136, 49,
                    64, None, 0.0)
    check_drop_path("vitb16@512 G96 S1025 D64", 8, 12, 1025, 1025, 64, None,
                    0.1)

    # the fused LayerNorm + Dense (row 14) at benchmarks/ln_fused.py's ViT-B
    # shapes (S 197, D 768, batch 32: R 6304) in its two forms, a ragged R
    # without a bias, and gelu_erf in fp32; the fused attention sub-block
    # (row 8) at ViT-B/16, DeiT-B (S 198), T2T-ViT-14 (H 6) and bucket 1;
    # into NaN-filled outputs, twice for equal bits
    def dense_inputs(seed, rows, d, n, dtype, with_bias=True):
        x = randn(seed, rows, d, dtype=dtype)
        g = (1 + 0.1 * randn(seed + 1, d, dtype=fp32))
        b = 0.1 * randn(seed + 2, d, dtype=fp32)
        w = (randn(seed + 3, d, n, dtype=fp32) / d ** 0.5).to(dtype)
        bias = 0.1 * randn(seed + 4, n, dtype=fp32) if with_bias else None
        return x, g, b, w, bias

    def check_ln_dense(label, rows, d, n, activation, with_bias, dtype):
        name = str(dtype).removeprefix("torch.")
        args = dense_inputs(100, rows, d, n, dtype, with_bias)
        kw = dict(activation=activation)
        out = fdense.ln_dense_fwd(*args, **kw, out=torch.full(
            (rows, n), float("nan"), dtype=dtype, device=dev))
        want = fdense.ln_dense_reference(*args, **kw)
        again = fdense.ln_dense_fwd(*args, **kw)
        torch.cuda.synchronize()
        e = max_err(out, want)
        tol = KERNEL_TOL[name] * max(1.0, want.float().abs().max().item())
        errs[("ln_dense", label, name)] = e
        log(f"ln_dense {label} {name}: max|out-plain| {e:.3e} (tol {tol:.3e})")
        require(not bool(torch.isnan(out.float()).any())
                and torch.equal(again, out) and e <= tol,
                f"ln_dense {label} {name}: every element written, reruns "
                "bit-equal, within tolerance of the plain version")

    for dtype in (bf16, fp32):
        check_ln_dense("[ln_1 + QKV] R6304 D768 N2304", 6304, 768, 2304, None,
                       True, dtype)
        check_ln_dense("[ln_2 + fc1 + GELU] R6304 D768 N3072", 6304, 768,
                       3072, "gelu_tanh", True, dtype)
        check_ln_dense("ragged R6301 N2304 no bias", 6301, 768, 2304, None,
                       False, dtype)
    check_ln_dense("gelu_erf R6304 N3072", 6304, 768, 3072, "gelu_erf", True,
                   fp32)

    def block_inputs(seed, b, s, hd, dtype):
        x = randn(seed, b, s, hd, dtype=dtype)
        rows = [1 + 0.1 * randn(seed + 1, hd, dtype=fp32),
                0.1 * randn(seed + 2, hd, dtype=fp32),
                0.1 * randn(seed + 3, 3 * hd, dtype=fp32),
                0.1 * randn(seed + 4, hd, dtype=fp32)]
        w = [(randn(seed + 5, hd, 3 * hd, dtype=fp32) / hd ** 0.5).to(dtype),
             (randn(seed + 6, hd, hd, dtype=fp32) / hd ** 0.5).to(dtype)]
        return x, rows[0], rows[1], w[0], rows[2], w[1], rows[3]

    def check_block(label, b, s, h, dh, dtype):
        name = str(dtype).removeprefix("torch.")
        args = block_inputs(110, b, s, h * dh, dtype)
        out = fa.fused_attention_block_fwd(
            *args, h, out=torch.full_like(args[0], float("nan")))
        want = fa.fused_attention_block_reference(*args, h)
        again = fa.fused_attention_block_fwd(*args, h)
        torch.cuda.synchronize()
        e = max_err(out, want)
        tol = KERNEL_TOL[name] * max(1.0, want.float().abs().max().item())
        errs[("fused_block", label, name)] = e
        log(f"fused_attention_block {label} {name}: max|out-plain| {e:.3e} "
            f"(tol {tol:.3e})")
        require(not bool(torch.isnan(out.float()).any())
                and torch.equal(again, out) and e <= tol,
                f"fused_attention_block {label} {name}: every element "
                "written, reruns bit-equal, within tolerance of the plain "
                "version")

    for dtype in (bf16, fp32):
        check_block("vitb16 B32 S197 H12", 32, 197, 12, 64, dtype)
        check_block("deit-b B32 S198 H12", 32, 198, 12, 64, dtype)
        check_block("t2t-vit-14 B32 S197 H6", 32, 197, 6, 64, dtype)
        check_block("vitb16 B1 S197 H12", 1, 197, 12, 64, dtype)

    # gradients through both autograd functions against autograd of their
    # plain versions, fp32
    def autograd_err(label, fn, ref, leaves, **kw):
        grads = []
        for f in (fn, ref):
            ts = [t.detach().clone().requires_grad_() for t in leaves]
            out = f(*ts, **kw)
            out.backward(randn(120, *out.shape, dtype=fp32))
            grads.append([t.grad for t in ts])
        e = max(grad_err(f"{label} d{i}", g, r, "float32")[0]
                for i, (g, r) in enumerate(zip(*grads)))
        log(f"{label} gradients vs autograd of the plain version: {e:.3e}")
        return e

    errs[("ln_dense", "grad")] = autograd_err(
        "ln_dense B4 S197 D768 N3072 gelu_tanh", fdense.ln_dense,
        fdense.ln_dense_reference,
        list(dense_inputs(121, 4 * 197, 768, 3072, fp32)),
        activation="gelu_tanh")
    errs[("fused_block", "grad")] = autograd_err(
        "fused_attention_block B2 S197 H12", fa.fused_attention_block,
        fa.fused_attention_block_reference,
        list(block_inputs(130, 2, 197, 768, fp32)), heads=12)

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
    for d_, m in split_models.items():
        with torch.inference_mode():
            require_route(f"split-head path forward {d_}",
                          lambda: m(x512.to(dev)), [("row 2", d_)])
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

    # ---- 5. window path: Swin-T and SwinV2-T served in bf16 ---------------
    swin, swin_weights = {}, {}
    for preset, cls in (("swint_224_imagenet", SwinTransformer),
                        ("swinv2t_224_imagenet", SwinTransformerV2)):
        sargs = get_args(preset)
        sshape = (sargs["image_size"], sargs["image_size"], 3)
        smodel = cls(**sargs, dtype="bfloat16")
        sweights = seeded_state_dict(smodel, seed=5)
        smodel.load_state_dict(sweights)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            serving.export_classifier(smodel, sshape, tmp, buckets=(1, 8, 32),
                                      dtype=fp32)
            del smodel
            sclf = serving.load_classifier(tmp)
        require(type(sclf.model) is cls, f"{preset}: the artifact rebuilds "
                f"a {cls.__name__}")
        forwards = [0]
        sclf.model.register_forward_hook(
            lambda *_, forwards=forwards: forwards.__setitem__(
                0, forwards[0] + 1))
        want = SWIN_LAUNCHES_PER_FORWARD[preset]

        def launches_match(n_forwards):
            return all(v == n_forwards * want.get(k, 0)
                       for k, v in fa.LAUNCHES.items())

        fa.reset_launch_counts()
        windows.ROUTE_LOG = []
        t0 = time.perf_counter()
        sclf.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        require(forwards[0] == 3 and launches_match(3),
                f"{preset}: warmup runs each bucket once through "
                f"{want} and no other attention kernel; got {fa.LAUNCHES}")
        routes = windows.ROUTE_LOG[:12]
        require(windows.ROUTE_LOG == routes * 3,
                f"{preset}: the same 12 routes at every bucket")
        windows.ROUTE_LOG = None
        total = dict(fa.LAUNCHES)
        sserved = {}
        for n in (1, 8, 32, 40):  # 40 = a full bucket of 32 + 8
            fa.reset_launch_counts()
            f0 = forwards[0]
            sserved[n] = sclf.predict(images[:n])
            torch.cuda.synchronize()
            require(forwards[0] - f0 == (2 if n == 40 else 1)
                    and launches_match(forwards[0] - f0),
                    f"{preset}: predict({n}) launches {want} per forward and "
                    f"no other attention kernel; got {fa.LAUNCHES}")
            require(sserved[n].shape == (n, sargs["num_classes"])
                    and bool(torch.isfinite(sserved[n].float()).all()),
                    f"{preset}: predict({n}) gives finite ({n}, classes) "
                    "logits")
            total = {k: v + fa.LAUNCHES[k] for k, v in total.items()}
        log(f"{preset}: {forwards[0]} forwards (warmup {warm_s:.2f} s), "
            f"routes per forward {routes}, launches "
            f"{ {k: v for k, v in total.items() if v} }")

        # the same weights on the CPU through the plain versions, fp32
        cpu_swin = cls(**sargs, device="cpu")
        cpu_swin.load_state_dict(sweights)
        with torch.no_grad():
            sref = cpu_swin(torch.from_numpy(images[:2])).float()
        del cpu_swin
        sscale = sref.abs().max().item()
        e16 = max(max_err(sserved[n][:k].cpu(), sref[:k])
                  for n, k in ((1, 1), (8, 2), (32, 2), (40, 2)))
        swin32 = cls(**sargs)
        swin32.load_state_dict(sweights)
        with torch.inference_mode():
            e32 = max_err(swin32(torch.from_numpy(images[:2]).to(dev)).cpu(),
                          sref)
        del swin32
        log(f"{preset} logits vs CPU fp32: fp32 model on the card {e32:.3e} "
            f"(tol {SWIN_LOGIT_TOL_FP32}), bf16 served {e16:.3e} (max|ref| "
            f"{sscale:.3f}, tol {LOGIT_TOL_BF16_REL} x max|ref|)")
        require(e32 <= SWIN_LOGIT_TOL_FP32
                and e16 <= LOGIT_TOL_BF16_REL * sscale,
                f"{preset}: logits against the CPU run of the same weights")
        swin[preset] = (sclf, total, forwards[0])
        swin_weights[preset] = sweights

    # ---- 6. training paths ------------------------------------------------
    # 6a. train_model on vit_tiny_cifar100: full size, fp32, dropout 0.1
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

    # 6b. ViT-B/16 @224, bf16, batch 32, attention dropout 0.1: 3 Adam steps
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

    # 6c. split-head training: 2 layers at 512 px (S = 1025), bf16, batch 2
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
        require_route(f"split-head train step bf16 rate {rate}",
                      lambda: trainer.train_step_fn(m)(st, x512_2, y512,
                                                       w512),
                      [("row 6", "bfloat16")]
                      + ([("row 2", "bfloat16")] if rate == 0.0 else []))
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

    # 6d. fp32 gradients, card against CPU (plain versions), 2 layers, rate 0
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

    # 6e. the windowed training path: Swin-T and SwinV2-T, bf16, batch 32
    def step_split(model, state, x, y, w, n=5):
        """Host ms per step and device ms of forward, backward, optimizer."""
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
              for _ in range(n)]
        model.train()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for e0, e1, e2, e3 in ev:
            e0.record()
            loss = trainer.cross_entropy_with_weights(model(x), y, w)
            e1.record()
            state.optimizer.zero_grad()
            loss.backward()
            e2.record()
            state.optimizer.step()
            e3.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / n * 1e3
        return (host, *(float(np.mean([e[i].elapsed_time(e[i + 1])
                                       for e in ev])) for i in range(3)))

    def log_profile(what, fn, top=12):
        wall, busy, count, ranked = device_profile(fn, top=top)
        if busy is None:
            log(f"profile {what}: the profiler saw no device activity")
            return
        log(f"profile {what}: wall {wall:.3f} ms (profiler on), device busy "
            f"{busy:.3f} ms in {count} activities, idle share "
            f"{1 - busy / wall:.3f}")
        for name, ms, n in ranked:
            log(f"  {ms:8.3f} ms {n:4d}x {name}")

    def train_phase(preset, model, weights, x, y, w, want_fwd, want_bwd):
        """3 steps with the fused and 3 with the unfused optimizer from the
        same weights: launches per step, the batch's eval loss before and
        after, the step's split. Returns (launches, times by optimizer)."""
        n_big = sum(p.numel() >= fadam._MIN_FUSED_SIZE
                    for p in model.parameters())
        evaluate = trainer.eval_step_fn(model)
        launches, times = {}, {}
        for fused in (True, False):
            model.load_state_dict(weights)
            state = trainer.make_train_state(
                model, tx=make_optimizer("adam", 1e-4, fused=fused))
            step = trainer.train_step_fn(model)
            before = (evaluate(model, x, y, w)[0] / 32).item()
            model.dropout_generator.manual_seed(0)
            fa.reset_launch_counts()
            losses = []
            for _ in range(3):
                state, loss_n, _, n = step(state, x, y, w)
                losses.append((loss_n / n).item())
            torch.cuda.synchronize()
            got = {k: v for k, v in fa.LAUNCHES.items() if v}
            after = (evaluate(model, x, y, w)[0] / 32).item()
            want = {k: 3 * v for k, v in {**want_fwd, **want_bwd}.items()}
            if fused:
                want["fused_adam"] = 3 * n_big
            log(f"{preset} bf16 batch 32, 3 Adam steps (fused={fused}) on one "
                f"batch: train-mode loss {[round(v, 4) for v in losses]}, "
                f"eval-mode loss of the batch {before:.4f} -> {after:.4f}, "
                f"launches {got}")
            require(np.isfinite(losses).all() and np.isfinite(after)
                    and after < before,
                    f"{preset} fused={fused}: finite losses, and the batch's "
                    "eval loss falls over 3 steps")
            require(got == want, f"{preset} fused={fused}: per step {want_fwd} "
                    f"forward, {want_bwd} backward"
                    + (f", {n_big} fused_adam" if fused else "")
                    + f" and no other kernel; got {got}")
            require(all(bool(torch.isfinite(p).all())
                        for p in model.parameters()),
                    f"{preset} fused={fused}: finite parameters")
            launches[fused] = got
            times[fused] = step_split(model, state, x, y, w)
            host, f_ms, b_ms, o_ms = times[fused]
            log(f"{preset} bf16 train step, batch 32, fused={fused}: "
                f"{host:.3f} ms per step by the host clock "
                f"({32 / host * 1e3:.1f} images/s); device time forward "
                f"{f_ms:.3f} ms, backward {b_ms:.3f} ms, optimizer "
                f"{o_ms:.3f} ms ({n_big} large leaves of "
                f"{sum(1 for _ in model.parameters())})")
            if fused:
                def one_step(state=state):
                    loss = trainer.cross_entropy_with_weights(model(x), y, w)
                    state.optimizer.zero_grad()
                    loss.backward()
                    state.optimizer.step()
                model.train()
                log_profile(f"{preset} train step (fused Adam)", one_step)
        return launches, times

    xb = torch.from_numpy(images[:32]).to(dev)
    yb = torch.from_numpy(rng.randint(0, 1000, 32)).to(dev)
    wb = torch.ones(32, device=dev)
    bwd12 = {"window_attention_bwd": 12}
    swin_train = {}
    for preset, cls in (("swint_224_imagenet", SwinTransformer),
                        ("swinv2t_224_imagenet", SwinTransformerV2)):
        smodel = cls(**get_args(preset), dtype="bfloat16")
        swin_train[preset] = train_phase(
            preset, smodel, swin_weights[preset], xb, yb, wb,
            SWIN_LAUNCHES_PER_FORWARD[preset], bwd12)
        if preset == "swint_224_imagenet":
            adam_model = smodel  # its leaves time the optimizers in phase 7
        del smodel

    # fp32 gradients of narrow 2-stage models, card against CPU (plain
    # versions); stochastic depth 0: its masks differ between devices
    narrow = dict(patch_size=[4, 4], embed_dim=32, depths=[2, 2],
                  num_heads=[1, 2], window_size=[7, 7], num_classes=10,
                  stochastic_depth_prob=0.0)
    xn = torch.from_numpy(rng.standard_normal((2, 56, 56, 3))
                          .astype(np.float32))
    yn = torch.tensor([3, 7])
    for cls in (SwinTransformer, SwinTransformerV2):
        sd = seeded_state_dict(cls(**narrow, device="cpu"), seed=6)
        grads = {}
        for device in ("cpu", "cuda"):
            m = cls(**narrow, device=device)
            m.load_state_dict(sd)
            m.train()
            fa.reset_launch_counts()
            loss = trainer.cross_entropy_with_weights(
                m(xn.to(device)), yn.to(device), torch.ones(2, device=device))
            loss.backward()
            grads[device] = (loss.item(), {n: p.grad.detach().cpu()
                                           for n, p in m.named_parameters()})
            if device == "cuda":
                require(fa.LAUNCHES["window_attention_bwd"] == 4,
                        "card gradients went through the window backward")
        g_ref = max(g.abs().max().item() for g in grads["cpu"][1].values())
        e_grad = max(max_err(grads["cuda"][1][n], g)
                     for n, g in grads["cpu"][1].items())
        log(f"fp32 gradients of a 2-stage {cls.__name__}, card vs CPU: loss "
            f"{grads['cuda'][0]:.6f} vs {grads['cpu'][0]:.6f}, max|dgrad| "
            f"{e_grad:.3e} (max|ref| {g_ref:.3e}, tol {MODEL_GRAD_TOL} x "
            f"max(1, max|ref|))")
        require(abs(grads["cuda"][0] - grads["cpu"][0]) <= 1e-4
                and e_grad <= MODEL_GRAD_TOL * max(1.0, g_ref),
                f"{cls.__name__}: card gradients against the CPU run")
    del grads

    # train_model on swin_tiny_cifar100 (32 px, window 4), fp32
    stiny_args = get_args("swin_tiny_cifar100")
    stiny = SwinTransformer(**stiny_args)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    shist = stiny.train_model(stiny, train_loader, test_loader, epochs,
                              val_loader, lr=1e-4, verbose=False)
    torch.cuda.synchronize()
    stiny_s = time.perf_counter() - t0
    stiny_launches = {k: v for k, v in fa.LAUNCHES.items() if v}
    log(f"train_model swin_tiny_cifar100, {epochs} epochs x {steps_per_epoch} "
        f"steps of 64 in {stiny_s:.2f} s: train loss "
        f"{[round(v, 4) for v in shist['train_loss']]}, train acc "
        f"{[round(v, 4) for v in shist['train_accuracy']]}, test acc "
        f"{[round(v, 4) for v in shist['test_accuracy']]}, launches "
        f"{stiny_launches}")
    require(keys <= set(shist) and all(
        len(shist[k]) == epochs and np.isfinite(shist[k]).all()
        for k in keys), "swin_tiny: the six keys, finite, one value per epoch")
    require(shist["train_loss"][-1] < shist["train_loss"][0]
            and shist["train_accuracy"][-1] > 0.5,
            "swin_tiny: train loss falls and train accuracy passes 0.5")
    require(stiny_launches["window_attention_bwd"]
            == 12 * shist["final_state"].step,
            "swin_tiny: 12 window backward launches per train step")
    del stiny

    # 6f. PVT-Tiny and Twins-SVT-S @224: served and trained, bf16
    hier = {}
    for preset, cls in (("pvt_tiny224_imagenet", PVT),
                        ("twins_svts224_imagenet", TwinSVT)):
        hargs = get_args(preset)
        hmodel = cls(**hargs, dtype="bfloat16")
        hweights = seeded_state_dict(hmodel, seed=7)
        hmodel.load_state_dict(hweights)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            serving.export_classifier(hmodel, (224, 224, 3), tmp,
                                      buckets=(1, 32), dtype=fp32)
            hclf = serving.load_classifier(tmp)
        require(type(hclf.model) is cls,
                f"{preset}: the artifact rebuilds a {cls.__name__}")
        want = HIER_LAUNCHES_PER_FORWARD[preset]
        fa.reset_launch_counts()
        windows.ROUTE_LOG = []
        hclf.warmup()
        routes = windows.ROUTE_LOG[:len(windows.ROUTE_LOG) // 2]
        require(windows.ROUTE_LOG == routes * 2
                and routes == (TWINS_ROUTES if cls is TwinSVT else []),
                f"{preset}: window routes per forward, got {routes}")
        windows.ROUTE_LOG = None
        hserved = {n: hclf.predict(images[:n]) for n in (1, 32)}
        torch.cuda.synchronize()
        got = {k: v for k, v in fa.LAUNCHES.items() if v}
        require(got == {k: 4 * v for k, v in want.items()},
                f"{preset}: {want} per forward over 4 forwards and no other "
                f"kernel; got {got}")
        cpu_h = cls(**hargs, device="cpu")
        cpu_h.load_state_dict(hweights)
        with torch.no_grad():
            href = cpu_h(torch.from_numpy(images[:2])).float()
        del cpu_h
        hscale = href.abs().max().item()
        e16 = max(max_err(hserved[n][:k].cpu(), href[:k])
                  for n, k in ((1, 1), (32, 2)))
        h32 = cls(**hargs)
        h32.load_state_dict(hweights)
        with torch.inference_mode():
            e32 = max_err(h32(torch.from_numpy(images[:2]).to(dev)).cpu(),
                          href)
        del h32
        log(f"{preset}: served at buckets 1 and 32, launches per forward "
            f"{want}, routes {routes}; logits vs CPU fp32: fp32 model on the "
            f"card {e32:.3e} (tol {SWIN_LOGIT_TOL_FP32}), bf16 served "
            f"{e16:.3e} (max|ref| {hscale:.3f}, tol {LOGIT_TOL_BF16_REL} x "
            "max|ref|)")
        require(all(bool(torch.isfinite(o.float()).all())
                    for o in hserved.values())
                and e32 <= SWIN_LOGIT_TOL_FP32
                and e16 <= LOGIT_TOL_BF16_REL * hscale,
                f"{preset}: logits against the CPU run of the same weights")
        # training: the split-head backward is the dropout kernel at rate 0;
        # Twins' 9 LSA blocks add their window forwards and the shared backward
        n_attn = want["flash_attention"]
        want_bwd = {"dropout_attention_bwd": n_attn}
        if cls is TwinSVT:
            want_bwd["window_attention_bwd"] = 9
        hier[preset] = (hclf, got, train_phase(
            preset, hmodel, hweights, xb, yb, wb, want, want_bwd))
        del hmodel

    # ---- 6g. the ViT family on the fused path (USE_FUSED_BLOCK) -----------
    # ViT-B/16, DeiT-B, CPE-ViT-B and T2T-ViT-14 (both token types) @224,
    # bf16, weights drawn into the JAX params layout and loaded through the
    # converters; served with the flag on at buckets 1, 8 and 32, then with
    # it off; fp32 on the card and the CPU; trained with the flag on
    family, family_runs = {}, []
    for label, (cls, kw, convert, layers, extra) in FAMILY.items():
        model = cls(**kw, dtype="bfloat16")
        fweights = getattr(port_jax, convert)(jax_shaped_weights(model, 40))
        model.load_state_dict(fweights, strict=True)
        vv.USE_FUSED_BLOCK = True
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            serving.export_classifier(model, shape, tmp, buckets=(1, 8, 32),
                                      dtype=fp32)
            del model
            fclf = serving.load_classifier(tmp)
        fwd = [0]
        fclf.model.register_forward_hook(
            lambda *_: fwd.__setitem__(0, fwd[0] + 1))
        fa.reset_launch_counts()
        fclf.warmup()
        fused_out = {n: fclf.predict(images[:n]) for n in (1, 8, 32)}
        torch.cuda.synchronize()
        got = {k: v for k, v in fa.LAUNCHES.items() if v}
        want = {k: v * fwd[0] for k, v in
                {"fused_attention_block": layers, **extra}.items()}
        log(f"{label} bf16 served with USE_FUSED_BLOCK: {fwd[0]} forwards "
            f"(buckets 1, 8, 32), launches {got}")
        require(got == want, f"{label}: per forward {layers} fused_attention_"
                f"block launches{', ' + str(extra) if extra else ''} and no "
                f"packed or other launch; got {got}")
        family_runs.append(got)
        x32 = torch.from_numpy(images[:32]).to(dev)
        with torch.inference_mode():
            fused_ms = cuda_ms(lambda: fclf.model(x32), iters=10)
        vv.USE_FUSED_BLOCK = False
        fwd[0] = 0
        fa.reset_launch_counts()
        plain_out = fclf.predict(images[:8])
        torch.cuda.synchronize()
        got_off = {k: v for k, v in fa.LAUNCHES.items() if v}
        want_off = {k: v * fwd[0] for k, v in
                    {"packed_attention": layers, **extra}.items()}
        require(got_off == want_off, f"{label} flag off: per forward {layers} "
                f"packed launches{', ' + str(extra) if extra else ''}; got "
                f"{got_off}")
        with torch.inference_mode():
            modular_ms = cuda_ms(lambda: fclf.model(x32), iters=10)
        cpu_model = cls(**kw, device="cpu")
        cpu_model.load_state_dict(fweights, strict=True)
        with torch.no_grad():
            ref = cpu_model(torch.from_numpy(images[:2])).float()
        del cpu_model
        scale = ref.abs().max().item()
        e_off = max_err(fused_out[8], plain_out)
        e_cpu = max_err(fused_out[8][:2].cpu(), ref)
        model32 = cls(**kw)
        model32.load_state_dict(fweights, strict=True)
        vv.USE_FUSED_BLOCK = True
        fa.reset_launch_counts()
        with torch.no_grad():
            out32 = model32(torch.from_numpy(images[:2]).to(dev)).float()
        torch.cuda.synchronize()
        vv.USE_FUSED_BLOCK = False
        require(fa.LAUNCHES["fused_attention_block"] == layers,
                f"{label} fp32: the fused kernel per layer")
        e32 = max_err(out32.cpu(), ref)
        del model32
        log(f"{label}: bf16 fused vs bf16 modular logits {e_off:.3e}, vs CPU "
            f"fp32 {e_cpu:.3e} (max|ref| {scale:.3f}, tol "
            f"{LOGIT_TOL_BF16_REL} x max|ref|); fp32 fused on the card vs CPU "
            f"{e32:.3e} (tol {LOGIT_TOL_FP32}); forward at batch 32, device "
            f"time: fused {fused_ms:.3f} ms, modular {modular_ms:.3f} ms")
        require(all(bool(torch.isfinite(o.float()).all())
                    and o.shape == (o.shape[0], 1000)
                    for o in fused_out.values())
                and e_off <= LOGIT_TOL_BF16_REL * scale
                and e_cpu <= LOGIT_TOL_BF16_REL * scale
                and e32 <= LOGIT_TOL_FP32,
                f"{label}: fused logits against the modular path and the CPU")
        family[label] = dict(clf=fclf, fused_ms=fused_ms,
                             modular_ms=modular_ms)

    # the three new models trained with the flag on: it does not engage in
    # training mode (no fused launch in a step), the packed kernels do
    vv.USE_FUSED_BLOCK = True
    fam_x = torch.from_numpy(images[:32]).to(dev)
    fam_y = torch.from_numpy(rng.randint(0, 1000, 32)).to(dev)
    fam_w = torch.ones(32, device=dev)
    for label, (cls, kw, convert, layers, extra) in FAMILY.items():
        if cls is ViT:
            continue  # trained in phase 6b
        model = cls(**kw, dtype="bfloat16")
        model.load_state_dict(getattr(port_jax, convert)(
            jax_shaped_weights(model, 41)), strict=True)
        evaluate = trainer.eval_step_fn(model)
        before = (evaluate(model, fam_x, fam_y, fam_w)[0] / 32).item()
        state = trainer.make_train_state(model,
                                         tx=make_optimizer("adam", 1e-4))
        step = trainer.train_step_fn(model)
        model.dropout_generator.manual_seed(0)
        fa.reset_launch_counts()
        losses = []
        for _ in range(3):
            state, loss_n, _, n = step(state, fam_x, fam_y, fam_w)
            losses.append((loss_n / n).item())
        torch.cuda.synchronize()
        got = {k: v for k, v in fa.LAUNCHES.items() if v}
        after = (evaluate(model, fam_x, fam_y, fam_w)[0] / 32).item()
        want = {k: 3 * v for k, v in {
            "packed_attention": layers, "packed_attention_bwd": layers,
            **extra,
            **({"dropout_attention_bwd": sum(extra.values())}
               if extra else {})}.items()}
        family_runs.append(got)
        host, f_ms, b_ms, o_ms = step_split(model, state, fam_x, fam_y,
                                            fam_w)
        log(f"{label} bf16 batch 32, 3 Adam steps with USE_FUSED_BLOCK set: "
            f"train-mode loss {[round(v, 4) for v in losses]}, eval-mode "
            f"loss of the batch {before:.4f} -> {after:.4f}, launches {got}; "
            f"step {host:.3f} ms by the host clock ({32 / host * 1e3:.1f} "
            f"images/s), device forward {f_ms:.3f}, backward {b_ms:.3f}, "
            f"optimizer {o_ms:.3f} ms")
        require(got == want, f"{label} training: per step {want} / 3 and no "
                f"fused_attention_block launch; got {got}")
        require(np.isfinite(losses).all() and after < before,
                f"{label}: finite losses, and the batch's eval loss falls")
        del model, state
    vv.USE_FUSED_BLOCK = False

    # row 14 as the public op: benchmarks/ln_fused.py's "fused" chain, 12
    # ViT-B/16 layers at batch 32, bf16 (ln_dense for [ln_1 + QKV] and
    # [ln_2 + fc1 + GELU], the packed kernel between), against its "base"
    # chain of library calls
    chain = dense_chain_weights(randn, bf16)
    xc = 0.02 * randn(140, 32, 197, 768, dtype=bf16)
    fa.reset_launch_counts()
    with torch.inference_mode():
        fused_chain = ln_fused_chain(xc, chain, fdense.ln_dense,
                                     fa.packed_flash_attention)
    torch.cuda.synchronize()
    ln_chain_launches = {k: v for k, v in fa.LAUNCHES.items() if v}
    with torch.inference_mode():
        base_chain = ln_fused_chain(xc, chain, base_ln_dense,
                                    fa.packed_flash_attention)
        chain_ms = {name: cuda_ms(lambda f=f: ln_fused_chain(
            xc, chain, f, fa.packed_flash_attention), iters=5)
            for name, f in (("fused", fdense.ln_dense),
                            ("base", base_ln_dense))}
    e_chain = max_err(fused_chain, base_chain)
    c_scale = base_chain.float().abs().max().item()
    log(f"ln_fused chain (12 ViT-B/16 layers, batch 32, bf16): launches "
        f"{ln_chain_launches}; fused {chain_ms['fused']:.3f} ms vs base "
        f"{chain_ms['base']:.3f} ms; max|fused - base| {e_chain:.3e} (max|base| "
        f"{c_scale:.3f})")
    require(ln_chain_launches == {"ln_dense": 24, "packed_attention": 12}
            and bool(torch.isfinite(fused_chain.float()).all())
            and e_chain <= LOGIT_TOL_BF16_REL * max(1.0, c_scale),
            "ln_fused chain: 2 ln_dense and 1 packed launch per layer, the "
            "base chain's output")

    # ---- 7. detection: DETR-R50 (DC5) at COCO scale ------------------------
    det_cfg = dict(num_classes=91, aux_loss=True)   # cli.run_detection_main
    det_w = None
    det_eval, det_models = {}, {}
    det_runs = []  # launches of every run of the detection path
    ds = SyntheticCoco(COCO_SIZES, seed=11)
    nt4, targets4 = next(iter(DetectionLoader(ds, 4)))
    require(nt4.tensors.shape == (4, 896, 1344, 3),
            f"four COCO-sized images collate to the 896 x 1344 bucket, got "
            f"{nt4.tensors.shape}")
    batch4 = nt4.to(dev)
    for dname in ("bfloat16", "float32"):
        det = Detr(**det_cfg, dtype=dname)
        if det_w is None:
            det_w = detr_state_dict_from_jax(jax_shaped_weights(det, seed=12))
        det.load_state_dict(det_w, strict=True)
        forwards = [0]
        det.register_forward_hook(
            lambda *_, forwards=forwards: forwards.__setitem__(
                0, forwards[0] + 1))
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = evaluate_model(det, DetectionLoader(ds, 4), device=dev)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        got = {k: v for k, v in fa.LAUNCHES.items() if v}
        det_runs.append(got)
        log(f"DETR-R50 {dname} evaluate_model, batch 4 at 896 x 1344 "
            f"(4704 C5 tokens): {eval_s:.2f} s with the first call, "
            f"{forwards[0]} forward, launches {got}, metrics {metrics}")
        require(forwards[0] == 1 and got == DETR_EVAL_LAUNCHES,
                f"DETR {dname} eval: {DETR_EVAL_LAUNCHES} per forward and no "
                f"other kernel; got {got}")
        require(all(np.isfinite(v) for v in metrics.values())
                and {"mAP", "AP50", "AR@100"} <= set(metrics),
                f"DETR {dname}: finite COCO metrics")
        with torch.inference_mode():
            out = det(batch4.tensors, batch4.mask)
            require(out["pred_logits"].shape == (4, 100, 92)
                    and out["pred_boxes"].shape == (4, 100, 4)
                    and len(out["aux_outputs"]) == 5
                    and bool(torch.isfinite(out["pred_logits"].float()).all())
                    and bool(((out["pred_boxes"] >= 0)
                              & (out["pred_boxes"] <= 1)).all()),
                    f"DETR {dname}: finite (4, 100, 92) logits, boxes in "
                    "[0, 1], 5 aux outputs")
            det_eval[dname] = {"out": {k: out[k].float()
                                       for k in ("pred_logits", "pred_boxes")}}
            fwd_ms = cuda_ms(lambda: det(batch4.tensors, batch4.mask),
                             iters=5, warmup=1)
            det_eval[dname]["fwd_ms"] = fwd_ms
            log(f"DETR-R50 {dname} eval forward, batch 4 at 896 x 1344, "
                f"device time {fwd_ms:.3f} ms ({4 / fwd_ms * 1e3:.1f} "
                "images/s)")
            log_profile(f"DETR-R50 {dname} eval forward, batch 4",
                        lambda: det(batch4.tensors, batch4.mask), top=12)
        det_models[dname] = det
    e16 = max_err(det_eval["bfloat16"]["out"]["pred_logits"],
                  det_eval["float32"]["out"]["pred_logits"])
    log(f"DETR-R50 bf16 against fp32 logits on the card: max|diff| "
        f"{e16:.3e} (max|fp32| "
        f"{det_eval['float32']['out']['pred_logits'].abs().max().item():.3f})")

    # fp32 on the card against the CPU run of the same weights, one image
    # padded to 512 x 640
    small = SyntheticCoco([(480, 620)], seed=14)
    nt1 = nested_tensor_from_tensor_list([small[0][0]])
    require(nt1.tensors.shape == (1, 512, 640, 3), "one image at 512 x 640")
    cpu_det = Detr(**det_cfg, device="cpu")
    cpu_det.load_state_dict(det_w, strict=True)
    with torch.no_grad():
        ref = cpu_det(*nt1.to("cpu").decompose())
    fa.reset_launch_counts()
    with torch.inference_mode():
        got_out = det_models["float32"](*nt1.to(dev).decompose())
    det_runs.append(dict(fa.LAUNCHES))
    scale = ref["pred_logits"].abs().max().item()
    e_logit = max_err(got_out["pred_logits"].cpu(), ref["pred_logits"])
    e_box = max_err(got_out["pred_boxes"].cpu(), ref["pred_boxes"])
    log(f"DETR-R50 fp32 at 512 x 640 (S 1280), card vs CPU: max|dlogits| "
        f"{e_logit:.3e} (max|ref| {scale:.3f}, tol {DETR_LOGIT_TOL_REL} x "
        f"max(1, max|ref|)), max|dboxes| {e_box:.3e} (tol {DETR_BOX_TOL}); "
        f"launches {dict((k, v) for k, v in fa.LAUNCHES.items() if v)}")
    require(e_logit <= DETR_LOGIT_TOL_REL * max(1.0, scale)
            and e_box <= DETR_BOX_TOL
            and fa.LAUNCHES["flash_attention_large"] == 12,
            "DETR fp32 outputs on the card against the CPU run")
    del cpu_det, det_models, ref

    # training: fit_detection, 3 steps at batch 2 on one 896 x 1344 batch
    train_ds = SyntheticCoco([COCO_SIZES[0], COCO_SIZES[2]], seed=15)
    nt2, targets2 = next(iter(DetectionLoader(train_ds, 2)))
    require(nt2.tensors.shape == (2, 896, 1344, 3), "train batch bucket")
    crit = SetCriterion(num_classes=91)

    def det_eval_loss(model):
        labels, boxes, valid = prepare_targets(targets2, 64, 91, dev)
        b = nt2.to(dev)
        model.eval()
        with torch.no_grad():
            out = model(b.tensors, b.mask)
            return crit.total_loss(crit(out, labels, boxes, valid)).item(), \
                out

    det_train = {}
    for rate in (0.1, 0.0):
        model = Detr(**det_cfg, dropout=rate, dtype="bfloat16")
        model.load_state_dict(det_w, strict=True)
        before, _ = det_eval_loss(model)
        fa.USE_PALLAS_BWD = rate == 0.0
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        hist = fit_detection(model, DetectionLoader(train_ds, 2), 3,
                             num_classes=91, seed=0, verbose=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        got = {k: v for k, v in fa.LAUNCHES.items() if v}
        det_runs.append(got)
        after, out_after = det_eval_loss(model)
        want = {k: 3 * v for k, v in DETR_TRAIN_LAUNCHES[rate].items()}
        log(f"DETR-R50 bf16 fit_detection, 3 steps at batch 2 (896 x 1344), "
            f"dropout {rate}, USE_PALLAS_BWD {fa.USE_PALLAS_BWD}: "
            f"{fit_s:.2f} s with the first step, train loss per epoch "
            f"{[round(v, 4) for v in hist['loss']]}, eval-mode loss of the "
            f"batch {before:.4f} -> {after:.4f}, launches {got}")
        require(hist["final_state"].step == 3 and got == want,
                f"DETR train at dropout {rate}: per step "
                f"{DETR_TRAIN_LAUNCHES[rate]} and no other kernel; got {got}")
        require(np.isfinite(hist["loss"]).all() and np.isfinite(after)
                and after < before,
                f"DETR train at dropout {rate}: the batch's eval loss falls")
        state = hist["final_state"]

        # the step's split: forward (with matching and loss), backward,
        # optimizer, CUDA events around the parts of training.detection
        labels, boxes, valid = prepare_targets(targets2, 64, 91, dev)
        b2 = nt2.to(dev)
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
              for _ in range(3)]
        model.train()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for e0, e1, e2, e3 in ev:
            e0.record()
            loss = crit.total_loss(crit(model(b2.tensors, b2.mask), labels,
                                        boxes, valid))
            e1.record()
            state.optimizer.zero_grad()
            loss.backward()
            e2.record()
            state.optimizer.step()
            e3.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / len(ev) * 1e3
        f_ms, b_ms, o_ms = (float(np.mean([e[i].elapsed_time(e[i + 1])
                                           for e in ev])) for i in range(3))
        det_train[rate] = dict(launches=got, host_ms=host, fwd_ms=f_ms,
                               bwd_ms=b_ms, opt_ms=o_ms)
        log(f"DETR-R50 bf16 train step, batch 2, dropout {rate}: {host:.3f} "
            f"ms per step by the host clock ({2 / host * 1e3:.2f} images/s); "
            f"device time forward + matching + loss {f_ms:.3f} ms, backward "
            f"{b_ms:.3f} ms, optimizer {o_ms:.3f} ms")

        def det_step(model=model, state=state):
            loss = crit.total_loss(crit(model(b2.tensors, b2.mask), labels,
                                        boxes, valid))
            state.optimizer.zero_grad()
            loss.backward()
            state.optimizer.step()

        log_profile(f"DETR-R50 bf16 train step, dropout {rate}", det_step,
                    top=12)
        require_route(f"DETR-R50 bf16 train step, dropout {rate}", det_step,
                      [("row 6", "bfloat16")]
                      + ([("row 2", "bfloat16")] if rate == 0.0 else []))
        if rate == 0.0:
            # the auction on the card against scipy on the step's cost
            cost = HungarianMatcher().cost(out_after, labels, boxes)
            auc = auction_assign(cost, valid)
            ref_idx = _host_assign(cost.cpu().numpy(), valid.cpu().numpy())
            c = cost.cpu().numpy()
            gap = spread = 0.0
            for i in range(c.shape[0]):
                n = int(valid[i].sum())
                mine = c[i, auc[i, :n].cpu().numpy(), np.arange(n)].sum()
                best = c[i, ref_idx[i, :n], np.arange(n)].sum()
                gap = max(gap, float(mine - best))
                spread = max(spread, float(c[i].max() - c[i].min()))
                require(len(set(auc[i, :n].tolist())) == n
                        and bool((auc[i, n:] == -1).all()),
                        "the auction gives a valid matching")
            same = bool((auc.cpu().numpy() == ref_idx).all())
            log(f"auction vs scipy on the trained step's cost (2 x 100 x 64): "
                f"identical {same}, worst total-cost gap {gap:.3e} (cost "
                f"spread {spread:.3f})")
            require(gap <= 0.01 * spread,
                    "the auction within 1% of the cost spread of scipy's")
        fa.USE_PALLAS_BWD = False
        del model, state, hist, loss

    # fp32 gradients of a narrow DETR (full ResNet-50), card against CPU,
    # both matched by scipy (the auction is the card's default), and the
    # diagnosis of their largest difference
    det_runs.append(narrow_detr_gradients())

    # the ViT-B backbone variant: 12 unmasked streaming launches at S 4704
    vdet = Detr(**det_cfg, backbone_arch="vit", dtype="bfloat16")
    vdet.load_state_dict(detr_state_dict_from_jax(jax_shaped_weights(vdet,
                                                                     18)),
                         strict=True)
    fa.reset_launch_counts()
    with torch.inference_mode():
        vout = vdet(batch4.tensors, batch4.mask)
    torch.cuda.synchronize()
    vit_launches = {k: v for k, v in fa.LAUNCHES.items() if v}
    det_runs.append(vit_launches)
    with torch.inference_mode():
        vit_fwd_ms = cuda_ms(lambda: vdet(batch4.tensors, batch4.mask),
                             iters=3, warmup=1)
    log(f"DETR ViT-B/16 backbone bf16, batch 4 at 896 x 1344 (S 4704): "
        f"launches {vit_launches}, forward {vit_fwd_ms:.3f} ms")
    require(vit_launches == {"flash_attention_large": 24,
                             "flash_attention": 6}
            and bool(torch.isfinite(vout["pred_logits"].float()).all()),
            "ViT backbone: 12 unmasked + 12 masked streaming launches and 6 "
            "split-head, finite logits")
    del vdet, vout

    # ---- 8. times ---------------------------------------------------------
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

    served_models = {**{k: v[0] for k, v in swin.items()},
                     **{k: v[0] for k, v in hier.items()}}
    for preset, sclf in served_models.items():
        for b in sclf.buckets:
            x = images[:b]
            for _ in range(2):
                sclf.predict(x).float().cpu()
            iters = 10
            t0 = time.perf_counter()
            for _ in range(iters):
                sclf.predict(x).float().cpu()
            ms = (time.perf_counter() - t0) / iters * 1e3
            log(f"serving {preset} bf16 bucket {b}: {ms:.3f} ms per request "
                f"(host numpy in, logits out), {b / ms * 1e3:.1f} images/s")
        with torch.inference_mode():
            xb = torch.from_numpy(images[:32]).to(dev)
            sfwd_ms = cuda_ms(lambda: sclf.model(xb), iters=10)
        log(f"{preset} bf16 forward, batch 32, device time: {sfwd_ms:.3f} ms "
            f"({32 / sfwd_ms * 1e3:.1f} images/s)")
        for b in (1, 32):
            log_profile(f"{preset} bucket {b}",
                        lambda: sclf.predict(images[:b]).float().cpu())

    # the ViT family served with the flag on and off: ms per request per
    # bucket, host numpy in and logits out
    for label, fam in family.items():
        for flag in (True, False):
            vv.USE_FUSED_BLOCK = flag
            for b in fam["clf"].buckets:
                x = images[:b]
                for _ in range(2):
                    fam["clf"].predict(x).float().cpu()
                t0 = time.perf_counter()
                for _ in range(5):
                    fam["clf"].predict(x).float().cpu()
                ms = (time.perf_counter() - t0) / 5 * 1e3
                log(f"serving {label} bf16 USE_FUSED_BLOCK={flag} bucket {b}: "
                    f"{ms:.3f} ms per request, {b / ms * 1e3:.1f} images/s")
            if label == "vitb16_224_imagenet":
                log_profile(f"{label} USE_FUSED_BLOCK={flag} bucket 32",
                            lambda: fam["clf"].predict(images[:32]).float()
                            .cpu())
    vv.USE_FUSED_BLOCK = False

    kernels = []
    port = "vision_transformers_tpu_torch/csrc/"
    jax_file = "vision_transformers_tpu/ops/flash_attention.py"

    # launches on the hierarchical models' paths: both Swins, PVT and Twins, each
    # served and trained
    path_runs = ([t for _, t, _ in swin.values()]
                 + [la for las, _ in swin_train.values() for la in las.values()]
                 + [got for _, got, _ in hier.values()]
                 + [la for _, _, (las, _) in hier.values()
                    for la in las.values()])
    swin_total = {k: sum(run.get(k, 0) for run in path_runs)
                  for k in fa.LAUNCHES}
    det_total = {k: sum(run.get(k, 0) for run in det_runs)
                 for k in fa.LAUNCHES}
    # the ViT family's serving (flag on and off) and training runs
    fam_total = {k: sum(run.get(k, 0) for run in family_runs)
                 for k in fa.LAUNCHES}

    def sdpa_backward(q, k, v, do, p, mask=None):
        """One call of SDPA's backward through autograd, graph kept."""
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                             dropout_p=p)
        return lambda: torch.autograd.grad(out, (q, k, v), do,
                                           retain_graph=True)

    def entry(name, source, line, launches, err, shape, k_ms, p_ms, l_ms,
              nbytes, flops, *, replaces=jax_file, ops_dtype="bfloat16",
              **extra):
        bnd, by = bound_ms(nbytes, flops, ops_dtype)
        require(launches > 0, f"{name}: launched on its path")
        kernels.append(dict(
            name=name, route="cuda", source=port + source,
            replaces=f"{replaces}:{line}", launches=launches, max_abs_err=err,
            ms=k_ms, plain_ms=p_ms, bound_ms=bnd, bound_by=by,
            library_ms=l_ms, **extra))
        more = "".join(f", {k} {v:.4f}" for k, v in extra.items())
        log(f"{name} {shape}: kernel {k_ms:.4f} ms, bound {bnd:.4f} ms "
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
          + vitb_launches["packed_attention"] + fam_total["packed_attention"],
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
          + vitb_launches["packed_attention_bwd"]
          + fam_total["packed_attention_bwd"],
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

    # rows 2 and 6 (bf16, tensor cores) at the paths' own shapes: kernel ms,
    # TFLOP/s of the work the inputs need (row 6 counts the keys its mask
    # attends), and SDPA's ms beside them as the yardstick
    def flash_path_times(key, b, h, s, d, bias_lead):
        q, k, v = (randn(84 + i, b, h, s, d, dtype=bf16) for i in range(3))
        bias = (None if bias_lead is None
                else randn(87, bias_lead, h, s, s, dtype=fp32))
        mask = None if bias is None else bias.to(bf16)
        k_ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, bias))
        return {f"{key}_ms": k_ms,
                f"{key}_tflops": 4 * b * h * s * s * d / k_ms / 1e9,
                f"{key}_sdpa_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask))}

    def drop_path_times(key, b, h, sq, sk, d, key_mask, rate):
        q, k, v, do = (randn(88 + i, b, h, n, d, dtype=bf16)
                       for i, n in enumerate((sq, sk, sk, sq)))
        kw = dict(dropout_rate=rate, seed=4321 + (11 << 34),
                  key_mask=key_mask)
        out, lse = fa.flash_dropout_attention_fwd(q, k, v, **kw)
        k_ms = cuda_ms(lambda: fa.flash_dropout_attention_bwd(
            q, k, v, do, out, lse, **kw), iters=10)
        keys = b * sk if key_mask is None else int(key_mask.sum().item())
        mask = None if key_mask is None else key_mask[:, None, None, :]
        return {f"{key}_ms": k_ms,
                f"{key}_tflops": 10 * h * sq * keys * d / k_ms / 1e9,
                f"{key}_sdpa_ms": cuda_ms(sdpa_backward(q, k, v, do, rate,
                                                        mask), iters=10)}

    # split-head: ViT-B/16 @512, batch 8, bf16 — the S = 1025 paths' shape
    b, h, s, d = 8, 12, 1025, 64
    shape = f"G{b * h} S{s} D{d}"
    q, k, v, do = (randn(7 + i, b, h, s, d, dtype=bf16) for i in range(4))
    io_bytes = b * h * s * d * 2
    lse_bytes = b * h * s * 4
    k_ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v), iters=10)
    entry("flash_attention", "flash_attention.cu", 75,
          split_launches["flash_attention"]
          + split_train_launches[0.0]["flash_attention"]
          + swin_total["flash_attention"] + det_total["flash_attention"]
          + fam_total["flash_attention"],
          errs[("flash", "vitb16@512 G96 S1025", "bfloat16")], shape, k_ms,
          cuda_ms(lambda: fa.flash_attention_reference(q, k, v), iters=10),
          cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=10),
          4 * io_bytes + lse_bytes, 4 * b * h * s * s * d,
          tflops=4 * b * h * s * s * d / k_ms / 1e9,
          detr_self_err=errs[("flash_path",
                              "detr decoder self B4 G32 S100 D32")],
          **flash_path_times("detr_self", 4, 8, 100, 32, None),
          **flash_path_times("detr_self_bias", 4, 8, 100, 32, 1))
    kw = dict(dropout_rate=rate, seed=seed)
    entry("dropout_attention_fwd", "dropout_attention.cu", 491,
          split_train_launches[0.1]["dropout_attention_fwd"]
          + det_total["dropout_attention_fwd"],
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
    k_ms = cuda_ms(lambda: fa.flash_dropout_attention_bwd(*bwd_args, **kw),
                   iters=10)
    entry("dropout_attention_bwd", "dropout_attention.cu", 525,
          split_train_launches[0.1]["dropout_attention_bwd"]
          + split_train_launches[0.0]["dropout_attention_bwd"]
          + swin_total["dropout_attention_bwd"]
          + det_total["dropout_attention_bwd"]
          + fam_total["dropout_attention_bwd"],
          errs[("drop_bwd", "vitb16@512 G96 S1025", "bfloat16", rate)],
          shape + f" rate {rate}", k_ms,
          cuda_ms(lambda: fa.flash_dropout_attention_bwd_reference(
              *bwd_args, **kw), iters=5),
          cuda_ms(sdpa_backward(q, k, v, do, rate), iters=10),
          8 * io_bytes + lse_bytes, 10 * b * h * s * s * d,
          rate0_ms=cuda_ms(lambda: fa.flash_dropout_attention_bwd(
              *bwd_args, dropout_rate=0.0, seed=None), iters=10),
          tflops=10 * b * h * s * s * d / k_ms / 1e9,
          detr_enc_err=errs[("drop_path", "detr encoder B2 G16 S4704 D32 "
                             "+ COCO key mask")],
          pvt_err=errs[("drop_path", "pvt stage 1 B32 G32 Sq3136 Sk49 D64")],
          **drop_path_times("detr_enc", 2, 8, 4704, 4704, 32,
                            coco_keep(COCO_SIZES[:2]), 0.1),
          **drop_path_times("pvt", 32, 1, 3136, 49, 64, None, 0.0))


    # the window kernels, each at its largest launch on the two Swin paths
    def split_heads(qkv, h):
        """(G, N, 3·H·dh) → contiguous q, k, v (G, H, N, dh), not timed."""
        g, n, c3 = qkv.shape
        return (t.reshape(g, n, h, c3 // (3 * h)).transpose(1, 2).contiguous()
                for t in qkv.split(c3 // 3, dim=-1))

    def window_bytes_flops(g, n, h, dh, nwp):
        """qkv read once, out written once, the bias once (bf16)."""
        return ((4 * g * n * h * dh + nwp * h * n * n) * 2,
                4 * g * h * n * n * dh)

    def window_entry(name, line, label, g, n, h, dh, nwp, other):
        qkv, bias = window_inputs(g, n, h, dh, nwp, bf16)
        q, k, v = split_heads(qkv, h)
        mask = bias.to(bf16).repeat(g // nwp, 1, 1, 1)
        nbytes, flops = window_bytes_flops(g, n, h, dh, nwp)
        fn, other_fn = getattr(fa, name), getattr(fa, other)
        entry(name, "window_attention.cu", line, swin_total[name],
              errs[(name, label, "bfloat16")],
              f"G{g} N{n} H{h} dh{dh} nW'{nwp}",
              cuda_ms(lambda: fn(qkv, bias, h)),
              cuda_ms(lambda: fa.window_attention_reference(qkv, bias, h)),
              cuda_ms(lambda: F.scaled_dot_product_attention(
                  q, k, v, attn_mask=mask)),
              nbytes, flops,
              **{f"{other}_ms": cuda_ms(lambda: other_fn(qkv, bias, h))})

    window_entry("window_packed_attention", 1295,
                 "swinv2-t s1 G1568 N64 H3 nW'49", 1568, 64, 3, 32, 49,
                 "window_batched_attention")
    window_entry("window_batched_attention", 1708,
                 "swin-t s1 G2048 N49 H3 shared", 2048, 49, 3, 32, 1,
                 "window_packed_attention")

    def fused_entry(kind, line, label, b, hw, win, shift, h, dh):
        name = f"window_fused_{kind}_attention"
        other = "flat" if kind == "slab" else "slab"
        qkv, bias, nwp = fused_inputs(b, hw, win, h, dh, True, bf16)
        plans = fused_plans(b, hw, win, h, dh, nwp)
        g = b * nwp
        mask = bias.to(bf16).repeat(b, 1, 1, 1)
        window, sh = (win, win), (shift, shift)

        def chain():
            """The same function from library calls: roll, partition, head
            split, SDPA with the bias as its mask, merge, reverse, roll."""
            x = torch.roll(qkv, shifts=(-shift, -shift), dims=(1, 2))
            q, k, v = split_heads(windows.window_partition(x, win, win), h)
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
            o = o.transpose(1, 2).reshape(g, win * win, h * dh)
            o = windows.window_reverse(o, win, win, hw, hw)
            return torch.roll(o, shifts=(shift, shift), dims=(1, 2))

        e = max_err(chain(), fa.window_fused_reference(qkv, bias, h, window, sh))
        require(e <= WINDOW_TOL["bfloat16"],
                f"the library chain computes the fused function ({e:.3e})")
        nbytes, flops = window_bytes_flops(g, win * win, h, dh, nwp)
        entry(name, "window_fused_attention.cu", line, swin_total[name],
              errs[(name, label, shift, "bfloat16")],
              f"B{b} {hw}x{hw} win{win} shift{shift} H{h} dh{dh} nW'{nwp}",
              cuda_ms(lambda: fa.fused_window_attention(
                  qkv, bias, h, window, sh, plan=plans[kind])),
              cuda_ms(lambda: fa.window_fused_reference(qkv, bias, h, window,
                                                        sh)),
              cuda_ms(chain), nbytes, flops,
              **({f"{other}_same_map_ms": cuda_ms(
                  lambda: fa.fused_window_attention(
                      qkv, bias, h, window, sh, plan=plans[other]))}
                 if other in plans else {}))

    fused_entry("flat", 1997, "swin-t s2 B32 28x28 H6", 32, 28, 7, 3, 6, 32)
    fused_entry("slab", 2056, "swin-t s1 B32 56x56 H3", 32, 56, 7, 3, 3, 32)

    # the window backward at its largest launch: Swin-T stage 1, batch 32
    g, n, h, dh, nwp = 2048, 49, 3, 32, 1
    qkv, bias = window_inputs(g, n, h, dh, nwp, bf16)
    do = randn(34, g, n, h * dh, dtype=bf16)
    q, k, v = split_heads(qkv, h)
    do_h = do.reshape(g, n, h, dh).transpose(1, 2).contiguous()
    mask = bias.to(bf16).repeat(g, 1, 1, 1)

    def sdpa_masked_backward():
        """SDPA's backward with the bias as its mask, graph kept; it gives
        no bias gradient."""
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
        return lambda: torch.autograd.grad(out, (ql, kl, vl), do_h,
                                           retain_graph=True)

    io = g * n * h * dh * 2
    entry("window_attention_bwd", "window_attention_bwd.cu", 1466,
          swin_total["window_attention_bwd"],
          errs[("window_attention_bwd", "swin-t s1 G2048 N49 H3 shared",
                "bfloat16")],
          f"G{g} N{n} H{h} dh{dh} nW'{nwp} bf16, dbias wanted",
          cuda_ms(lambda: fa.window_attention_bwd(qkv, bias, do, h)),
          cuda_ms(lambda: fa.window_attention_bwd_reference(qkv, bias, do, h),
                  iters=10),
          cuda_ms(sdpa_masked_backward()),
          # qkv and do read, dqkv written, the bias read, ds written
          7 * io + nwp * h * n * n * 2 + g * h * n * n * 2,
          10 * g * h * n * n * dh,
          no_dbias_ms=cuda_ms(lambda: fa.window_attention_bwd(
              qkv, bias, do, h, need_dbias=False)))
    sw_t = swin_train["swint_224_imagenet"][1][True]
    log(f"  the 12 launches of a Swin-T step are part of its {sw_t[2]:.3f} ms "
        "backward")
    del qkv, bias, do, q, k, v, do_h, mask

    # the single-pass Adam kernel on Swin-T's largest leaf (stage 4's fc1,
    # 768 x 3072: ViT-B/16's fc1 too), and the optimizers over all of
    # Swin-T's leaves
    leaf = [randn(60 + i, 768, 3072, dtype=fp32) * sc
            for i, sc in enumerate((1.0, 0.0, 0.0, 0.01))]
    sc = fadam.adam_scalars(5, 1e-4)
    lib_p = leaf[0].clone().requires_grad_()
    lib_p.grad = leaf[3].clone()
    lib_opt = torch.optim.Adam([lib_p], lr=1e-4, fused=True)
    n_el = leaf[0].numel()
    params = [p for p in adam_model.parameters()]
    for p_ in params:
        p_.grad = torch.full_like(p_, 1e-3)
    opt_ms = {}
    for label, tx in (("fused", make_optimizer("adam", 1e-4, fused=True)),
                      ("unfused", make_optimizer("adam", 1e-4))):
        tx.init(params)
        opt_ms[label] = cuda_ms(tx.step, iters=10)
    lib_all = torch.optim.Adam(params, lr=1e-4, fused=True)
    opt_ms["library"] = cuda_ms(lib_all.step, iters=10)
    n_all = sum(p_.numel() for p_ in params)
    entry("fused_adam", "fused_adam.cu", 36, swin_total["fused_adam"],
          max(errs[("fused_adam", 0.0)], errs[("fused_adam", 0.05)]),
          f"one fp32 leaf of {n_el} elements",
          cuda_ms(lambda: fadam._launch([leaf], sc)),
          cuda_ms(lambda: fadam.fused_adam_reference(*leaf, sc)),
          cuda_ms(lib_opt.step),
          7 * 4 * n_el, 12 * n_el,
          replaces="vision_transformers_tpu/ops/fused_adam.py",
          ops_dtype="float32",
          swin_t_step_fused_ms=opt_ms["fused"],
          swin_t_step_unfused_ms=opt_ms["unfused"],
          swin_t_step_library_ms=opt_ms["library"],
          swin_t_step_bound_ms=7 * 4 * n_all / HBM_BYTES_PER_S * 1e3)
    # the streaming forward at the DETR-R50 encoder's eval shape (batch 4 at
    # 896 x 1344), beside its cross shape and the ViT-B S 1297 shape; the
    # bound counts the keys this data attends (masked keys need no work)
    b, h, s, d = 4, 8, 4704, 32
    q, k, v = (randn(80 + i, b, h, s, d, dtype=bf16) for i in range(3))
    qc = randn(83, b, h, 100, d, dtype=bf16)
    qv, kv, vv = (randn(84 + i, 2, 12, 1297, 64, dtype=bf16)
                  for i in range(3))
    n_keys = int(det_keep.sum())
    sdpa_mask = det_keep[:, None, None, :]
    io_bytes = b * h * s * d * 2
    entry("flash_attention_large", "flash_attention_large.cu", 229,
          det_total["flash_attention_large"]
          + fam_total["flash_attention_large"],
          errs[("large", "detr-r50 encoder B4 G32 S4704 D32", "bfloat16")],
          f"G{b * h} S{s} D{d}, the key masks of {COCO_SIZES}",
          cuda_ms(lambda: fa.flash_attention_large_fwd(q, k, v,
                                                       kv_mask=det_keep),
                  iters=5),
          cuda_ms(lambda: fa.flash_attention_large_reference(
              q, k, v, kv_mask=det_keep), iters=3),
          cuda_ms(lambda: F.scaled_dot_product_attention(
              q, k, v, attn_mask=sdpa_mask), iters=5),
          4 * io_bytes + b * h * s * 4 + det_keep.numel(),
          4 * h * s * n_keys * d,
          cross_sq100_ms=cuda_ms(lambda: fa.flash_attention_large_fwd(
              qc, k, v, kv_mask=det_keep), iters=5),
          cross_sq100_library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
              qc, k, v, attn_mask=sdpa_mask), iters=5),
          vitb_s1297_ms=cuda_ms(lambda: fa.flash_attention_large_fwd(
              qv, kv, vv), iters=5),
          vitb_s1297_library_ms=cuda_ms(
              lambda: F.scaled_dot_product_attention(qv, kv, vv), iters=5))
    log(f"  x6 encoder layers = {6 * kernels[-1]['ms']:.3f} ms of the "
        f"{det_eval['bfloat16']['fwd_ms']:.3f} ms bf16 eval forward at batch 4")
    del q, k, v, qc, qv, kv, vv

    # the small-S backward at the DETR decoder's self attention in a train
    # step (batch 2), beside ViT-B/16's S 197 at batch 32
    def small_bwd_inputs(seed, b, h, s, d):
        q, k, v, do = (randn(seed + i, b, h, s, d, dtype=bf16)
                       for i in range(4))
        out, lse = fa.flash_attention_fwd(q, k, v)
        return q, k, v, out, lse, do

    def row6(q, k, v, out, lse, do):
        return fa.flash_dropout_attention_bwd(q, k, v, do, out, lse,
                                              dropout_rate=0.0, seed=None)

    dargs = small_bwd_inputs(88, 2, 8, 100, 32)
    vargs = small_bwd_inputs(92, 32, 12, 197, 64)
    g, s, d = 16, 100, 32
    entry("flash_attention_bwd", "flash_attention_bwd.cu", 362,
          det_total["flash_attention_bwd"],
          errs[("small_bwd", "detr decoder self B2 G16 S100 D32",
                "bfloat16")],
          f"G{g} S{s} D{d}",
          cuda_ms(lambda: fa.flash_attention_bwd(*dargs)),
          cuda_ms(lambda: fa.flash_attention_bwd_reference(*dargs)),
          cuda_ms(sdpa_backward(*dargs[:3], dargs[5], 0.0)),
          8 * g * s * d * 2 + g * s * 4, 10 * g * s * s * d,
          row6_rate0_ms=cuda_ms(lambda: row6(*dargs)),
          vitb_g384_s197_ms=cuda_ms(lambda: fa.flash_attention_bwd(*vargs)),
          vitb_g384_s197_row6_ms=cuda_ms(lambda: row6(*vargs)),
          vitb_g384_s197_library_ms=cuda_ms(
              sdpa_backward(*vargs[:3], vargs[5], 0.0)),
          vitb_g384_s197_bound_ms=bound_ms(8 * 384 * 197 * 64 * 2
                                           + 384 * 197 * 4,
                                           10 * 384 * 197 * 197 * 64,
                                           "bfloat16")[0])
    del dargs, vargs

    # the fused LayerNorm + Dense at benchmarks/ln_fused.py's ViT-B shapes,
    # batch 32: [ln_1 + QKV], with [ln_2 + fc1 + GELU] beside it; the
    # library call is F.layer_norm -> F.linear (+ F.gelu)
    r, d = 32 * 197, 768
    qkv_in = dense_inputs(150, r, d, 2304, bf16)
    fc1_in = dense_inputs(155, r, d, 3072, bf16)
    gelu = dict(activation="gelu_tanh")

    def ln_bytes(n):
        """x read, W read, out written (bf16); gamma, beta, bias (fp32)."""
        return (r * d + d * n + r * n) * 2 + (2 * d + n) * 4

    entry("ln_dense", "ln_dense.cu", 72, ln_chain_launches["ln_dense"],
          max(v for k, v in errs.items() if k[0] == "ln_dense"
              and k[-1] == "bfloat16"),
          f"R{r} D{d} N2304 [ln_1 + QKV]",
          cuda_ms(lambda: fdense.ln_dense_fwd(*qkv_in)),
          cuda_ms(lambda: fdense.ln_dense_reference(*qkv_in)),
          cuda_ms(lambda: base_ln_dense(*qkv_in)),
          ln_bytes(2304), 2 * r * d * 2304,
          replaces="vision_transformers_tpu/ops/fused_dense.py",
          fc1_gelu_ms=cuda_ms(lambda: fdense.ln_dense_fwd(*fc1_in, **gelu)),
          fc1_gelu_plain_ms=cuda_ms(lambda: fdense.ln_dense_reference(
              *fc1_in, **gelu)),
          fc1_gelu_library_ms=cuda_ms(lambda: base_ln_dense(*fc1_in, **gelu)),
          fc1_gelu_bound_ms=bound_ms(ln_bytes(3072), 2 * r * d * 3072,
                                     "bfloat16")[0],
          chain_fused_ms=chain_ms["fused"], chain_base_ms=chain_ms["base"])
    del qkv_in, fc1_in

    # the fused attention sub-block at ViT-B/16 @224, batch 32, beside bucket
    # 1 and T2T-ViT-14's 6 heads; the library chain is LN -> F.linear ->
    # SDPA -> F.linear + residual
    def library_block(x, g, be, wqkv, bqkv, wout, bout, h):
        b, s, hd = x.shape
        xn = F.layer_norm(x, (hd,), g.to(x.dtype), be.to(x.dtype), 1e-6)
        qkv = F.linear(xn, wqkv.t(), bqkv.to(x.dtype))
        q, k, v = (t.view(b, s, h, hd // h).transpose(1, 2)
                   for t in qkv.split(hd, dim=-1))
        o = F.scaled_dot_product_attention(q, k, v)
        return x + F.linear(o.transpose(1, 2).reshape(b, s, hd), wout.t(),
                            bout.to(x.dtype))

    def block_cost(b, s, hd):
        """(bytes, FLOPs): x read, the weights read, out written (bf16), the
        fp32 rows; the two projections and the attention products."""
        return ((2 * b * s * hd + 4 * hd * hd) * 2 + 6 * hd * 4,
                2 * b * s * hd * 4 * hd + 4 * b * s * s * hd)

    blk = block_inputs(160, 32, 197, 768, bf16)
    blk1 = block_inputs(161, 1, 197, 768, bf16)
    blk_t2t = block_inputs(162, 32, 197, 384, bf16)
    casts = [torch.zeros(n, 768, device=dev) for n in (2304, 768)]
    vit_fam = family["vitb16_224_imagenet"]
    entry("fused_attention_block", "fused_block.cu", 1028,
          fam_total["fused_attention_block"],
          max(v for k, v in errs.items() if k[0] == "fused_block"
              and k[-1] == "bfloat16"),
          "B32 S197 H12 dh64 (ViT-B/16)",
          cuda_ms(lambda: fa.fused_attention_block_fwd(*blk, 12)),
          cuda_ms(lambda: fa.fused_attention_block_reference(*blk, 12)),
          cuda_ms(lambda: library_block(*blk, 12)),
          *block_cost(32, 197, 768),
          bucket1_ms=cuda_ms(lambda: fa.fused_attention_block_fwd(*blk1, 12)),
          bucket1_library_ms=cuda_ms(lambda: library_block(*blk1, 12)),
          bucket1_bound_ms=bound_ms(*block_cost(1, 197, 768), "bfloat16")[0],
          t2t14_ms=cuda_ms(lambda: fa.fused_attention_block_fwd(*blk_t2t, 6)),
          t2t14_library_ms=cuda_ms(lambda: library_block(*blk_t2t, 6)),
          t2t14_bound_ms=bound_ms(*block_cost(32, 197, 384), "bfloat16")[0],
          weight_casts_per_layer_ms=cuda_ms(
              lambda: [c.to(bf16) for c in casts]),
          vitb_forward_fused_ms=vit_fam["fused_ms"],
          vitb_forward_modular_ms=vit_fam["modular_ms"])
    log(f"  x12 layers = {12 * kernels[-1]['ms']:.3f} ms of the "
        f"{vit_fam['fused_ms']:.3f} ms flag-on ViT-B/16 forward at batch 32 "
        f"(flag off {vit_fam['modular_ms']:.3f} ms); its per-call weight "
        f"casts {12 * kernels[-1]['weight_casts_per_layer_ms']:.3f} ms")
    del blk, blk1, blk_t2t, casts

    require(len(kernels) == len(fa.LAUNCHES),
            "every kernel of the launch table has its line")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
