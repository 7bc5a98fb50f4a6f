"""Training steps back to back, as ``fit`` drives them.

Parameters (the workload file's ``params``):
- ``batch``: images a step;
- ``distinct``: distinct batches in the seeded host pool, fed in turn;
- ``lr``, ``weight_decay``: AdamW's, through ``make_optimizer(...,
  fused=True)`` (one Adam launch a step);
- ``normalize``: the (mean, std) that the step applies on the device to
  the uint8 NHWC images, as ``fit``'s loader feeds them.

Set-up builds one train step (``train_step_fn``) with its model and
optimizer state and drives it through its first three steps, on three
distinct batches, through the same call and feed as the window; the window
takes that same object from step four on. Those three steps are checked:
the plain fp32 reference follows them from the same weights, batches and
stochastic-depth seeds, and three numbers are compared, each a gap between
the program's reading and the reference's:

- ``first_loss_gap``: of the first step's loss, relative (the losses of
  the second and third steps carry the noise of Adam's first updates, which
  move each weight by about the learning rate whatever its gradient, so
  their gaps swing from seed to seed; they are printed, not compared);
- ``grad_gap``: of each leaf's norm of the first gradient as the optimizer
  got it (the first moment after one step over 1 − β1), over the larger of
  that leaf's reference norm and the median leaf's, the worst leaf;
- ``change_gap``: the same of each leaf's change after three steps;
- ``grad_err``: each leaf's ‖program's first gradient − reference's‖ over
  the same denominator, the worst leaf. Gaps of norms are second order in
  rounding errors that are independent of the gradient, and a float8
  control's are: where a cell's norm gaps do not separate its control,
  this number does.

A cell compares the numbers its file gives limits for.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of both leaf gaps, and elements whose reference
gradient is under a thousandth of the median leaf's per element are left
out of the change: Adam moves them by rounding alone (the key third of a
packed qkv bias has no gradient under the softmax).
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench.harness import host_array
from portbench.reference.common import (
    AdamW,
    Quant,
    block_seeds,
    cross_entropy,
    no_tf32,
    normalize,
)

CHECKED_STEPS = 3
BETA1 = 0.9
NEGLIGIBLE = 1e-3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Traffic:
    train = True

    def __init__(self, ctx):
        self.ctx = ctx
        p = ctx.params
        self.batch = int(p["batch"])
        self.distinct = int(p["distinct"])
        self.lr = float(p["lr"])
        self.wd = float(p["weight_decay"])
        self.mean, self.std = p["normalize"]
        m = ctx.model_cfg
        self.shape = (m["image_size"], m["image_size"],
                      m.get("in_channels", 3))

    def _pool(self) -> None:
        ctx = self.ctx
        gen = torch.Generator(device=ctx.device).manual_seed(
            ctx.seed_of("inputs"))
        self.images, self.labels = [], []
        for _ in range(self.distinct):
            self.images.append(host_array(torch.randint(
                0, 256, (self.batch, *self.shape), dtype=torch.uint8,
                generator=gen, device=ctx.device)))
            self.labels.append(host_array(torch.randint(
                0, ctx.model_cfg["num_classes"], (self.batch,),
                generator=gen, device=ctx.device)))
        self.weights = np.ones((self.batch,), np.float32)

    def setup(self) -> None:
        from vision_transformers_tpu_torch.training import trainer
        from vision_transformers_tpu_torch.training.optimizers import (
            make_optimizer,
        )

        ctx = self.ctx
        self._pool()
        start = ctx.weights()
        model = ctx.program_model()
        model.load_state_dict(start, strict=True)
        model.dropout_generator.manual_seed(ctx.seed_of("drop"))
        tx = make_optimizer("adamw", self.lr, weight_decay=self.wd,
                            fused=True)
        self.state = trainer.make_train_state(model, tx=tx)
        self.step = trainer.train_step_fn(model,
                                          normalize=(self.mean, self.std))
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        losses, grads = [], None
        for i in range(CHECKED_STEPS):
            _, loss_n, _, n = self.step(self.state, *self.feed(i))
            losses.append(float(loss_n) / float(n))
            if i == 0:
                # the first gradient as the optimizer got it, kept on the
                # host for the check
                grads = {k: (m / (1 - BETA1)).cpu() for k, m in
                         zip(names, self.state.optimizer.state["mu"])}
        change = {k: (p.detach() - start[k]).cpu() for k, p in
                  zip(names, self.state.optimizer.params)}
        self.observed = (losses, grads, change)
        del start
        self.i = CHECKED_STEPS

    def feed(self, i: int):
        k = i % self.distinct
        return self.images[k], self.labels[k], self.weights

    def iteration(self, i: int) -> None:
        """The next step; steps go on from where set-up left them, so the
        argument is not read."""
        with record_function("bench.step"):
            self.last = self.step(self.state, *self.feed(self.i))
        self.i += 1

    def run(self, seconds: float) -> dict:
        dev = self.ctx.device
        _sync(dev)
        start = time.perf_counter()
        steps = 0
        while time.perf_counter() - start < seconds:
            self.iteration(steps)
            steps += 1
        _sync(dev)
        window = time.perf_counter() - start
        _, loss_n, _, n = self.last
        self.ctx.notes["steps"] = (
            f"{steps} in {window:.4f} s, last loss "
            f"{float(loss_n) / float(n):.6f}")
        return {"train": True, "batch": self.batch,
                "items": steps * self.batch, "window_s": window,
                "attempted": steps, "failed": 0,
                "end_to_end": {"train_img_per_s": steps * self.batch / window}}

    def release(self) -> None:
        del self.state, self.step
        self.last = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, quant: Quant = Quant.none, half: bool = False):
        """The plain reference's losses over the checked steps, its first
        gradient and each leaf's change after them (tensors by leaf name).
        ``half``: the loss is the mean over the first half of each batch
        only (a fault, for the limits)."""
        no_tf32()
        ctx = self.ctx
        ref, m = ctx.cell.reference, ctx.model_cfg
        params = ctx.weights(requires_grad=True)
        start = {k: v.detach().clone() for k, v in params.items()}
        opt = AdamW(params, self.lr, self.wd)
        gen = torch.Generator().manual_seed(ctx.seed_of("drop"))
        count = ref.seeds_per_forward(m)
        weights = torch.tensor(self.weights, device=ctx.device)
        if half:
            weights[self.batch // 2:] = 0.0
        losses, grads = [], None
        for i in range(CHECKED_STEPS):
            images, labels, _ = self.feed(i)
            x = normalize(torch.from_numpy(images).to(ctx.device),
                          self.mean, self.std)
            y = torch.from_numpy(labels).to(ctx.device)
            seeds = block_seeds(gen, count) if count else None
            loss = cross_entropy(ref.forward(params, x, m, quant, seeds), y,
                                 weights)
            g = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            if i == 0:
                grads = dict(zip(params, g))
            opt.step(dict(zip(params, g)))
            del g, loss
        change = {k: params[k].detach() - start[k] for k in params}
        return losses, grads, change

    def readings(self) -> dict:
        ref = self.reference()
        self.ctx.notes["loss gaps by step"] = [
            abs(a - b) / abs(b) for a, b in zip(self.observed[0], ref[0])]
        return gaps(self.observed, ref)

    def control_readings(self) -> dict:
        """The reference in fp8 put in the program's place."""
        return gaps(self.reference(Quant.fp8), self.reference())

    def half_batch_readings(self) -> dict:
        """The reference with half of each batch left out of the loss."""
        return gaps(self.reference(half=True), self.reference())


def gaps(observed, reference) -> dict:
    """The numbers the check compares (the module's docstring); both sides
    are (losses, first gradient, change), tensors by leaf name.

    A leaf whose reference gradient norm is under ``NEGLIGIBLE`` × the
    median leaf's is left out, and so, in the change, is each element
    whose reference gradient is under ``NEGLIGIBLE`` × the median leaf's
    gradient per element (the key third of a packed qkv bias)."""
    (lp, gp, dp), (lr, gr, dr) = observed, reference
    worst = lambda xs: float(np.max(list(xs)))  # noqa: E731  (NaN stays)
    first_loss_gap = abs(lp[0] - lr[0]) / abs(lr[0])
    gnorm = {k: float(g.norm()) for k, g in gr.items()}
    med_g = statistics.median(gnorm.values())
    med_elem = statistics.median(gnorm[k] / gr[k].numel() ** 0.5
                                 for k in gr)
    kept = [k for k in gr if gnorm[k] >= NEGLIGIBLE * med_g]
    grad_gap = worst(abs(float(gp[k].norm()) - gnorm[k]) / max(gnorm[k], med_g)
                     for k in kept)
    grad_err = worst(float((gp[k].to(gr[k].device) - gr[k]).norm())
                     / max(gnorm[k], med_g) for k in kept)
    dn_p, dn_r = {}, {}
    for k in kept:
        live = gr[k].abs() >= NEGLIGIBLE * med_elem
        dn_p[k] = float(dp[k].to(live.device)[live].norm())
        dn_r[k] = float(dr[k][live].norm())
    med_d = statistics.median(dn_r.values())
    change_gap = worst(abs(dn_p[k] - dn_r[k]) / max(dn_r[k], med_d)
                       for k in kept)
    return {"first_loss_gap": first_loss_gap, "grad_gap": grad_gap,
            "grad_err": grad_err, "change_gap": change_gap}
