"""Closed-loop offline scoring: one client sends a batch of images, waits
for the logits on the host, and sends the next.

Parameters (the workload file's ``params``):
- ``batch``: images a request, which is also the artifact's one bucket;
- ``distinct``: distinct requests in the seeded pool, sent in turn.

A request goes through the port's serving path as a user calls it:
``export_classifier`` → ``load_classifier`` → ``ServingClassifier.predict``
on fp32 NHWC numpy images, then ``.float().cpu().numpy()``. The latency of
a request is host to host, from the call to the numpy logits.

The check compares every image of every request answered in the window
with the plain fp32 reference's logits for the same image: the reading is
the largest ‖program − reference‖ / ‖reference‖ over the 1000 logits of an
image.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench.harness import host_array
from portbench.reference.common import Quant, no_tf32

REF_ROWS = 64  # images a reference forward takes at once


class Traffic:
    train = False

    def __init__(self, ctx):
        self.ctx = ctx
        self.batch = int(ctx.params["batch"])
        self.distinct = int(ctx.params["distinct"])
        m = ctx.model_cfg
        self.shape = (m["image_size"], m["image_size"],
                      m.get("in_channels", 3))
        self.answers = []

    def setup(self) -> None:
        from vision_transformers_tpu_torch import serving

        ctx = self.ctx
        model = ctx.program_model()
        model.load_state_dict(ctx.weights(), strict=True)
        artifact = tempfile.mkdtemp(prefix="portbench-artifact-")
        try:
            serving.export_classifier(model, self.shape, artifact,
                                      buckets=(self.batch,),
                                      dtype=torch.float32)
            del model
            self.clf = serving.load_classifier(artifact, device=ctx.device)
        finally:
            shutil.rmtree(artifact)
        self.clf.warmup()
        gen = torch.Generator(device=ctx.device).manual_seed(
            ctx.seed_of("inputs"))
        self.pool = [host_array(torch.randn(
            (self.batch, *self.shape), generator=gen, device=ctx.device))
            for _ in range(self.distinct)]
        for i in range(self.distinct):
            self.iteration(i)

    def request(self, i: int) -> np.ndarray:
        with record_function("bench.predict"):
            logits = self.clf.predict(self.pool[i % self.distinct])
        with record_function("bench.readback"):
            return logits.float().cpu().numpy()

    def iteration(self, i: int) -> None:
        self.request(i)

    def run(self, seconds: float) -> dict:
        latencies = []
        start = time.perf_counter()
        end = start
        i = 0
        while True:
            t0 = time.perf_counter()
            if t0 - start >= seconds:
                break
            logits = self.request(i)
            end = time.perf_counter()
            latencies.append(end - t0)
            self.answers.append((i % self.distinct, logits))
            i += 1
        window = end - start
        lat = np.asarray(latencies)
        self.ctx.notes["requests"] = (
            f"{len(lat)} in {window:.4f} s, median "
            f"{np.median(lat) * 1e3:.4f} ms, p95 "
            f"{np.percentile(lat, 95) * 1e3:.4f} ms, max "
            f"{lat.max() * 1e3:.4f} ms")
        return {"train": False, "batch": self.batch,
                "items": len(lat) * self.batch, "window_s": window,
                "attempted": len(lat), "failed": 0,
                "end_to_end": {
                    "infer_img_per_s": len(lat) * self.batch / window,
                    "infer_p95_ms": float(np.percentile(lat, 95)) * 1e3}}

    def release(self) -> None:
        del self.clf
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_logits(self, quant: Quant = Quant.none) -> list:
        """The plain reference's logits of each distinct request, fp32
        with TF32 off (``quant``: the precision of its products)."""
        no_tf32()
        ctx = self.ctx
        weights = ctx.weights()
        out = []
        with torch.no_grad():
            for images in self.pool:
                x = torch.from_numpy(images).to(ctx.device)
                out.append(torch.cat([
                    ctx.cell.reference.forward(weights, x[r: r + REF_ROWS],
                                               ctx.model_cfg, quant)
                    for r in range(0, len(x), REF_ROWS)]).cpu().numpy())
        return out

    def readings(self) -> dict:
        return {"logits_rel_err": worst_image(
            self.answers, self.reference_logits())}

    def control_readings(self) -> dict:
        """The reference in fp8 put in the program's place."""
        low = self.reference_logits(Quant.fp8)
        return {"logits_rel_err": worst_image(
            list(enumerate(low)), self.reference_logits())}


def worst_image(answers, reference) -> float:
    """Largest ‖answer − reference‖ / ‖reference‖ over the images of all
    answers; ``answers`` are (distinct request, logits) pairs."""
    worst = 0.0
    ref = [r.astype(np.float64) for r in reference]
    norms = [np.linalg.norm(r, axis=1) for r in ref]
    for k, logits in answers:
        err = np.linalg.norm(logits.astype(np.float64) - ref[k], axis=1)
        w = float(np.max(err / norms[k]))
        if not w <= worst:  # larger, or not a number: kept
            worst = w
            if w != w:
                return w
    return worst
