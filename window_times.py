"""Times the window kernels (rows 9-13 of PERF.md's kernel table) at the
Swin-T shapes and the bf16 served forwards of Swin-T, SwinV2-T and
Twins-SVT-S on one card, with no profiler, and prints one JSON object.

It reaches the port only through its public API, so it can time another
checkout of the port the same way: ``--tree DIR`` imports the port from DIR
(built there at first use) instead of from this file's directory. For an
A/B of two trees, run it once per tree in alternating order (A, B, B, A),
each in a process of its own, one after another on the same card.

``--sass`` adds a digest of the SASS (``cuobjdump -sass``) of every
tensor-core kernel of rows 9 and 10 (``window_packed_mma_kernel``,
``window_bwd_mma_kernel``), by its name with the anonymous namespace's
path-dependent hash taken out: equal digests in two trees mean equal code.

``--head-dims`` times only rows 11 and 10 in bf16 at head dims above 64
(``HEAD_DIM_SHAPES``: Swin-T's stage 1 and a window of 64 tokens at one
head), with the route each tree's ``window_route`` names, and builds only
the window kernels.

    python3 window_times.py [--tree DIR] [--sass | --head-dims] > times.json
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from chip_smoke import cuda_ms, queued_ms, seeded_state_dict  # noqa: E402

# (G, N, H, dh, nW') of rows 9-11 and (B, Hp = Wp, window, shift, H, dh) of
# rows 12 and 13, at batch 32: Swin-T's stages (SwinV2-T's stage 1 for row 9)
WINDOW_SHAPES = {
    "row 9 swinv2-t s1 G1568 N64 H3 nW'49": ("packed", (1568, 64, 3, 32, 49)),
    "row 9 swin-t s1 G2048 N49 H3 nW'1": ("packed", (2048, 49, 3, 32, 1)),
    "row 10 swin-t s1 G2048 N49 H3 nW'1": ("bwd", (2048, 49, 3, 32, 1)),
    "row 11 swin-t s1 G2048 N49 H3 nW'1": ("batched", (2048, 49, 3, 32, 1)),
    "row 12 swin-t s2 B32 28x28 H6 shift3": ("flat", (32, 28, 7, 3, 6, 32)),
    "row 12 swin-t s3 B32 14x14 H12 shift3": ("flat", (32, 14, 7, 3, 12, 32)),
    "row 12 swin-t s3 B32 14x14 H12 shift0": ("flat", (32, 14, 7, 0, 12, 32)),
    "row 13 swin-t s1 B32 56x56 H3 shift3": ("slab", (32, 56, 7, 3, 3, 32)),
}
# (G, N, H, dh, nW') of rows 11 and 10 at head dims above 64 (--head-dims):
# Swin-T's stage 1 at batch 32 (G 2048, N 49) at one head of 96 and of 80,
# and 64-token windows (SwinV2-T's at 256 px, G 2048) at one head of 96
HEAD_DIM_SHAPES = {
    f"row {row} G2048 N{n} H1 dh{dh} nW'1": (kind, (2048, n, 1, dh, 1))
    for n, dh in ((49, 96), (49, 80), (64, 96))
    for row, kind in ((11, "batched"), (10, "bwd"))}
SERVED = ("swint_224_imagenet", "swinv2t_224_imagenet",
          "twins_svts224_imagenet")
REQUESTS = 30  # timed requests a model, after 3 warm ones


def window_times(fa, dev, shapes=WINDOW_SHAPES):
    """{label: {"ms": back to back, "device_ms": queued}} in bf16; with
    ``shapes`` HEAD_DIM_SHAPES also each kernel's "route"."""
    import torch

    def randn(seed, *shape, dtype=torch.bfloat16):
        g = torch.Generator(device="cpu").manual_seed(seed)
        return torch.randn(*shape, generator=g).to(dev, dtype)

    out = {}
    for label, (kind, shape) in shapes.items():
        route = None
        if kind in ("packed", "bwd", "batched"):
            g, n, h, dh, nwp = shape
            route = fa.window_route(torch.bfloat16, n, dh, kind)
            qkv = randn(30, g, n, 3 * h * dh)
            bias = randn(31, nwp, h, n, n, dtype=torch.float32)
            if kind == "bwd":
                do = randn(34, g, n, h * dh)
                call = lambda: fa.window_attention_bwd(  # noqa: E731
                    qkv, bias, do, h)
            else:
                fn = getattr(fa, f"window_{kind}_attention")
                call = lambda: fn(qkv, bias, h)  # noqa: E731
        else:
            b, hw, win, shift, h, dh = shape
            nwp = (hw // win) ** 2 if shift else 1
            qkv = randn(32, b, hw, hw, 3 * h * dh)
            bias = randn(33, nwp, h, win * win, win * win, dtype=torch.float32)
            plan_fn = (fa.window_fused_flat_plan if kind == "flat"
                       else fa.window_fused_plan)
            plan = plan_fn(b, hw, hw, win, win, h, dh, nwp)
            call = lambda: fa.fused_window_attention(  # noqa: E731
                qkv, bias, h, (win, win), (shift, shift), plan=plan)
        out[label] = {"ms": cuda_ms(call), "device_ms": queued_ms([call])[0]}
        if shapes is HEAD_DIM_SHAPES:
            out[label]["route"] = route
    return out


def served_times(dev):
    """{preset: {"request_ms": [...], "forward_ms": x}}: wall ms of each
    bf16 request at bucket 32 (host numpy in, logits out) and the model's
    forward at batch 32 by CUDA events."""
    import torch
    from vision_transformers_tpu_torch import serving
    from vision_transformers_tpu_torch.models.image_classification import (
        SwinTransformer, SwinTransformerV2, TwinSVT)
    from vision_transformers_tpu_torch.utils.args import get_args

    classes = dict(zip(SERVED, (SwinTransformer, SwinTransformerV2, TwinSVT)))
    images = np.random.RandomState(1).standard_normal(
        (32, 224, 224, 3)).astype(np.float32)
    out = {}
    for preset, cls in classes.items():
        model = cls(**get_args(preset), dtype="bfloat16")
        model.load_state_dict(seeded_state_dict(model, seed=5))
        with tempfile.TemporaryDirectory(prefix="window_times_") as tmp:
            serving.export_classifier(model, (224, 224, 3), tmp,
                                      buckets=(32,), dtype=torch.float32)
            del model
            clf = serving.load_classifier(tmp)
        for _ in range(3):
            clf.predict(images).float().cpu()
        ms = []
        for _ in range(REQUESTS):
            t0 = time.perf_counter()
            clf.predict(images).float().cpu()
            ms.append((time.perf_counter() - t0) * 1e3)
        with torch.inference_mode():
            xb = torch.from_numpy(images).to(dev)
            fwd = cuda_ms(lambda: clf.model(xb), iters=10)
        out[preset] = {"request_ms": ms, "request_median_ms": float(
            np.median(ms)), "forward_ms": fwd}
        del clf
    return out


def sass_digests(_build):
    """{kernel: sha256 of its SASS} for rows 9 and 10's tensor-core
    kernels, from the libraries as built."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME, "bin", "cuobjdump")
    out = {}
    for lib, kernel in (("window_attention", "window_packed_mma_kernel"),
                        ("window_attention_bwd", "window_bwd_mma_kernel")):
        _build.build([lib])
        text = subprocess.run([tool, "-sass", str(_build._lib_path(lib))],
                              capture_output=True, text=True,
                              check=True).stdout
        # the anonymous namespace's name holds hashes of the source's path
        text = re.sub(r"_GLOBAL__N__[0-9a-f]+_|(?<=_cu_)[0-9a-f]{8}", "", text)
        for part in text.split("Function : ")[1:]:
            name, body = part.split("\n", 1)
            if kernel in name:
                out[name.strip()] = hashlib.sha256(body.encode()).hexdigest()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE,
                    help="root of the checkout whose port is timed")
    ap.add_argument("--sass", action="store_true",
                    help="also digest rows 9 and 10's tensor-core SASS")
    ap.add_argument("--head-dims", action="store_true",
                    help="time only rows 11 and 10 at HEAD_DIM_SHAPES")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("window_times.py needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    from vision_transformers_tpu_torch.ops import _build
    from vision_transformers_tpu_torch.ops import flash_attention as fa

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(fa.__file__)))
    dev = torch.device("cuda")
    if args.head_dims:
        _build.build(["window_attention", "window_attention_bwd"])
    else:
        _build.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    result = {"tree": pkg, "card": card.strip().splitlines()[0]}
    if args.head_dims:
        result["kernels"] = window_times(fa, dev, HEAD_DIM_SHAPES)
    else:
        result.update(kernels=window_times(fa, dev),
                      served=served_times(dev))
    if args.sass:
        result["sass"] = sass_digests(_build)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
