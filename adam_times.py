"""Times the Adam optimizer step of the port (row 15 of PERF.md's kernel
table) on one card, with no profiler, and prints one JSON object: one
768 x 3072 fp32 leaf, and all the leaves of Swin-T and of ViT-B/16 @224,
each through ``make_optimizer("adam", fused=True)``, the unfused
``make_optimizer("adam")`` and ``torch.optim.Adam(fused=True)`` on the same
tensors. For each: device time (CUDA events while the stream is kept full)
with the L2 cache warm from the step before and cold (flushed before each
step), the back-to-back time of consecutive steps, the host's enqueue time
per step, and the kernels a fused step launched, by the kernel libraries'
launch logs.

It reaches the port only through its public API, so it can time another
checkout of the port the same way: ``--tree DIR`` imports the port from DIR
(built there at first use). For an A/B of two trees, run it once per tree in
alternating order (A, B, B, A), each in a process of its own, one after
another on the same card.

    python3 adam_times.py [--tree DIR] > times.json
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from chip_smoke import cold_ms, cuda_ms, queued_ms  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)


def host_ms(fn, iters=10):
    """Host ms of one call of ``fn``: the clock around ``iters`` calls with
    no synchronisation between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def step_times(params, make_optimizer, _build):
    """{optimizer: {device_ms, cold_device_ms, ms, host_ms[, launched]}}
    of one step over ``params`` (gradients of 1e-3 each)."""
    import torch

    for p in params:
        p.grad = torch.full_like(p, 1e-3)
    out = {}
    for label, tx in (
            ("fused", make_optimizer("adam", 1e-4, fused=True).init(params)),
            ("unfused", make_optimizer("adam", 1e-4).init(params)),
            ("library", torch.optim.Adam(params, lr=1e-4, fused=True))):
        times = {"device_ms": queued_ms([tx.step], reps=5)[0],
                 "cold_device_ms": cold_ms(tx.step, reps=5),
                 "ms": cuda_ms(tx.step, iters=10), "host_ms": host_ms(tx.step)}
        if label == "fused":
            torch.cuda.synchronize()
            _build.reset_launched()
            tx.step()
            torch.cuda.synchronize()
            times["launched"] = _build.launched()
        out[label] = times
    n = sum(p.numel() for p in params)
    out["leaves"], out["elements"] = len(params), n
    out["bound_ms"] = 7 * 4 * n / HBM_BYTES_PER_S * 1e3
    for p in params:
        p.grad = None
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE,
                    help="root of the checkout whose port is timed")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("adam_times.py needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    from vision_transformers_tpu_torch.models.image_classification import (
        SwinTransformer, ViT)
    from vision_transformers_tpu_torch.ops import _build
    from vision_transformers_tpu_torch.training.optimizers import (
        make_optimizer)
    from vision_transformers_tpu_torch.utils.args import get_args

    _build.build(["fused_adam"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(_build.__file__)))
    gen = torch.Generator(device="cuda").manual_seed(60)
    leaf = [torch.empty(768, 3072, device="cuda").normal_(generator=gen)
            .requires_grad_()]
    result = {"tree": pkg, "card": card.strip().splitlines()[0],
              "one_leaf": step_times(leaf, make_optimizer, _build)}
    for label, cls, preset in (("swin_t", SwinTransformer,
                                "swint_224_imagenet"),
                               ("vit_b16", ViT, "vitb16_224_imagenet")):
        model = cls(**get_args(preset))
        result[label] = step_times(list(model.parameters()), make_optimizer,
                                   _build)
        del model
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
