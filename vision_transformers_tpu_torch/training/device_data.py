"""Device-resident training: the whole dataset on the card, augmentation in
the step.

Counterpart of ``vision_transformers_tpu/training/device_data.py``. For
CIFAR-scale datasets (50k × 32 × 32 × 3 uint8 is 150 MB) the dataset is put
on the device once; each epoch shuffles with a permutation drawn there,
slices its batches there, augments them there (random crop after a 4-pixel
zero pad, horizontal flip, brightness jitter: the reference's recipe,
load_data.py:52) and runs the train step. Host↔device traffic per epoch is
the loss and accuracy read at its end.

What differs from the JAX package: PyTorch runs eagerly, so an epoch is a
Python loop of steps, not one compiled program; the draws come from a
``torch.Generator`` on the data's device, seeded by ``seed``, so they cannot
match JAX's PRNG bit for bit (``apply_augment`` takes given draws, which is
how the two are compared). ``fit_on_device`` keeps ``trainer.fit``'s
metrics-dict contract.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vision_transformers_tpu_torch.training.trainer import (
    TrainState,
    cross_entropy_with_weights,
    make_train_state,
    refuse_serving_only,
)


def apply_augment(images: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                  flips: torch.Tensor, factors: torch.Tensor,
                  pad: int = 4) -> torch.Tensor:
    """Crop at (ys, xs) of the zero-padded batch, flip where ``flips``,
    multiply by ``factors`` and clip: a uint8 (B, H, W, C) batch → float32
    in [0, 255]. ys, xs: (B,) integers in [0, 2·pad]; flips: (B,) bool;
    factors: (B,) float."""
    b, h, w, _ = images.shape
    padded = F.pad(images, (0, 0, pad, pad, pad, pad))
    dev = images.device
    rows = ys.to(dev).long()[:, None] + torch.arange(h, device=dev)[None, :]
    cols = xs.to(dev).long()[:, None] + torch.arange(w, device=dev)[None, :]
    out = padded[torch.arange(b, device=dev)[:, None, None],
                 rows[:, :, None], cols[:, None, :]]
    out = torch.where(flips.to(dev).bool()[:, None, None, None],
                      out.flip(2), out)
    f = factors.to(dev, torch.float32)[:, None, None, None]
    return (out.float() * f).clamp(0.0, 255.0)


def augment_batch_on_device(images: torch.Tensor,
                            generator: torch.Generator, pad: int = 4,
                            flip_p: float = 0.5,
                            brightness: float = 63 / 255) -> torch.Tensor:
    """Random crop (pad) + horizontal flip + brightness jitter on a uint8
    NHWC batch on its device, drawing crop offsets, flips and factors from
    ``generator`` (on the same device) → float32 in [0, 255]; the
    normalisation comes next, in the step."""
    b = images.shape[0]
    kw = dict(generator=generator, device=images.device)
    ys = torch.randint(0, 2 * pad + 1, (b,), **kw)
    xs = torch.randint(0, 2 * pad + 1, (b,), **kw)
    flips = torch.rand(b, **kw) < flip_p
    factors = (1 - brightness) + 2 * brightness * torch.rand(b, **kw)
    return apply_augment(images, ys, xs, flips, factors, pad)


def _normalize(x: torch.Tensor, normalize) -> torch.Tensor:
    x = x.float() / 255.0
    if normalize is not None:
        mean, std = (torch.as_tensor(v, dtype=torch.float32, device=x.device)
                     for v in normalize)
        x = (x - mean) / std
    return x


def fit_on_device(
    model,
    train_data: Tuple[np.ndarray, np.ndarray],
    test_data: Tuple[np.ndarray, np.ndarray],
    epochs: int,
    val_data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    *,
    batch_size: int = 256,
    normalize=None,
    augment: bool = True,
    lr: float = 1e-4,
    optimizer: str = "adam",
    seed: int = 0,
    state: Optional[TrainState] = None,
    verbose: bool = True,
    **opt_kwargs,
):
    """Train with the dataset on the model's device: per epoch one
    permutation, ``len // batch_size`` steps (the ragged tail of the
    permutation is dropped, as in the JAX package) and one host read.
    Returns the reference-parity metrics dict plus ``final_state``."""
    refuse_serving_only(model)
    dev = next(model.parameters()).device

    def put(d):
        x, y = d
        return (torch.as_tensor(np.ascontiguousarray(x), device=dev),
                torch.as_tensor(np.asarray(y, np.int64), device=dev))

    train_x, train_y = put(train_data)
    test = put(test_data)
    val = put(val_data) if val_data is not None else None
    n_train = train_x.shape[0]
    steps = n_train // batch_size
    if steps < 1:
        raise ValueError(f"{n_train} training images make no batch of "
                         f"{batch_size}")
    if state is None:
        state = make_train_state(model, lr=lr, optimizer=optimizer,
                                 **opt_kwargs)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if getattr(model, "dropout_generator", None) is not None:
        model.dropout_generator.manual_seed(seed)
    ones = torch.ones(batch_size, device=dev)

    def train_epoch():
        model.train()
        perm = torch.randperm(n_train, generator=gen, device=dev)
        totals = torch.zeros(2, device=dev)
        for i in range(steps):
            idx = perm[i * batch_size:(i + 1) * batch_size]
            imgs, labels = train_x[idx], train_y[idx]
            if augment:
                imgs = augment_batch_on_device(imgs, gen)
            logits = model(_normalize(imgs, normalize))
            loss = cross_entropy_with_weights(logits, labels, ones)
            state.optimizer.zero_grad()
            loss.backward()
            state.optimizer.step()
            state.step += 1
            with torch.no_grad():
                totals += torch.stack((loss.detach() * batch_size,
                                       (logits.argmax(-1) == labels).sum()))
        loss_sum, correct = totals.tolist()  # the epoch's one sync
        return loss_sum / (steps * batch_size), correct / (steps * batch_size)

    @torch.no_grad()
    def eval_pass(xs, ys):
        model.eval()
        totals = torch.zeros(2, device=dev)
        for i in range(0, xs.shape[0], batch_size):
            labels = ys[i:i + batch_size]
            logits = model(_normalize(xs[i:i + batch_size], normalize))
            loss = cross_entropy_with_weights(
                logits, labels, torch.ones(labels.shape[0], device=dev))
            totals += torch.stack((loss * labels.shape[0],
                                   (logits.argmax(-1) == labels).sum()))
        loss_sum, correct = totals.tolist()
        n = max(xs.shape[0], 1)
        return loss_sum / n, correct / n

    history = {
        "train_loss": [], "val_loss": [] if val is not None else None,
        "test_loss": [],
        "train_accuracy": [], "val_accuracy": [] if val is not None else None,
        "test_accuracy": [],
    }
    for epoch in range(epochs):
        tl, ta = train_epoch()
        history["train_loss"].append(tl)
        history["train_accuracy"].append(ta)
        if val is not None:
            vl, va = eval_pass(*val)
            history["val_loss"].append(vl)
            history["val_accuracy"].append(va)
        el, ea = eval_pass(*test)
        history["test_loss"].append(el)
        history["test_accuracy"].append(ea)
        if verbose:
            print(f"Epoch {epoch + 1}/{epochs} - Train Loss: {tl:.4f}, "
                  f"Train Acc: {ta:.4f}, Test Loss: {el:.4f}, "
                  f"Test Acc: {ea:.4f}")
    model.eval()
    history["final_state"] = state
    return history
