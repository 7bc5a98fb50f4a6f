"""The one shared trainer.

Counterpart of ``vision_transformers_tpu/training/trainer.py``, with the
reference's semantics: cross-entropy loss, Adam lr=1e-4 by default,
per-epoch train → (optional) val → test phases, a progress bar, and a
returned metrics dict with keys {train,val,test}_{loss,accuracy}.

What it keeps of the JAX trainer's design:
- uint8 batches travel to the device; normalisation runs there.
- Loss and accuracy accumulate as device scalars; the host reads them once
  per epoch (and at ``log_every`` when ``verbose``).
- A ragged final batch is padded and masked with per-example weights, so
  every step sees one shape.
- ``steps_per_call`` stacks k batches per call; a chunk's all-padding filler
  batches are skipped.

What differs: PyTorch runs eagerly, so there is no jit and no donated
state; the model and the optimizer are updated in place and a
``TrainState`` just holds them with the step count. Dropout randomness
comes from the model's own generator, which ``fit(seed=...)`` seeds, not
from a key passed to each step. A mesh, checkpointing and distillation
belong to modules that are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vision_transformers_tpu_torch.training.optimizers import (
    Optimizer,
    make_optimizer,
)


@dataclass
class TrainState:
    """The model, its optimizer and the number of train steps taken; both
    objects are updated in place by the train step."""

    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0


def cross_entropy_with_weights(logits, labels, weights):
    """Weighted-mean CE over valid (weight=1) examples; matches
    nn.CrossEntropyLoss mean reduction when all weights are 1."""
    per_ex = F.cross_entropy(logits.float(), labels, reduction="none")
    total_w = torch.clamp(weights.sum(), min=1.0)
    return (per_ex * weights).sum() / total_w


def _default_preprocess(images, normalize):
    """On-device normalization: uint8 NHWC → normalized float."""
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    if normalize is not None:
        mean, std = (torch.as_tensor(v, dtype=torch.float32, device=x.device)
                     for v in normalize)
        x = (x - mean) / std
    return x


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _to_device(device, images, labels, weights):
    return (torch.as_tensor(images, device=device),
            torch.as_tensor(labels, device=device).long(),
            torch.as_tensor(weights, device=device).float())


def train_step_fn(model, normalize=None, loss_fn=None):
    """Build the train step for a classification model:
    ``step(state, images, labels, weights)`` → (state, loss·n, correct, n),
    the last three as scalars on the model's device. Inputs may be numpy
    arrays or tensors; they are moved to the model's device."""
    loss_fn = loss_fn or cross_entropy_with_weights

    def step(state: TrainState, images, labels, weights):
        images, labels, weights = _to_device(_model_device(model), images,
                                             labels, weights)
        x = _default_preprocess(images, normalize)
        model.train()
        logits = model(x)
        loss = loss_fn(logits, labels, weights)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            pred = logits.argmax(dim=-1)
            correct = ((pred == labels) * weights).sum()
            n = weights.sum()
            return state, loss.detach() * n, correct, n

    return step


def eval_step_fn(model, normalize=None, loss_fn=None):
    """``step(model, images, labels, weights)`` → (loss·n, correct, n) in
    eval mode, without gradients."""
    loss_fn = loss_fn or cross_entropy_with_weights

    @torch.no_grad()
    def step(model_, images, labels, weights):
        images, labels, weights = _to_device(_model_device(model_), images,
                                             labels, weights)
        x = _default_preprocess(images, normalize)
        model_.eval()
        logits = model_(x)
        loss = loss_fn(logits, labels, weights)
        pred = logits.argmax(dim=-1)
        correct = ((pred == labels) * weights).sum()
        n = weights.sum()
        return loss * n, correct, n

    return step


def _sum_steps(results, device):
    if not results:
        zero = torch.zeros((), device=device)
        return zero, zero.clone(), zero.clone()
    return tuple(torch.stack(t).sum() for t in zip(*results))


def multi_train_step_fn(model, normalize=None, loss_fn=None):
    """k steps per call over batches stacked to (k, B, ...): a Python loop
    (PyTorch runs eagerly; there is no scan to amortise). A batch whose
    weights are all 0 (an epoch-tail filler) is skipped. Pass ``weights``
    as a numpy array and that test costs no device synchronisation."""
    step = train_step_fn(model, normalize, loss_fn)

    def multi(state: TrainState, images, labels, weights):
        results = []
        for im, lb, w in zip(images, labels, weights):
            if float(w.sum()) > 0:
                state, l, c, n = step(state, im, lb, w)
                results.append((l, c, n))
        return (state, *_sum_steps(results, _model_device(model)))

    return multi


def multi_eval_step_fn(model, normalize=None, loss_fn=None):
    step = eval_step_fn(model, normalize, loss_fn)

    def multi(model_, images, labels, weights):
        results = [step(model_, im, lb, w)
                   for im, lb, w in zip(images, labels, weights)]
        return _sum_steps(results, _model_device(model_))

    return multi


def make_train_state(model, tx: Optional[Optimizer] = None, lr: float = 1e-4,
                     optimizer: str = "adam", **opt_kwargs) -> TrainState:
    if tx is None:
        tx = make_optimizer(optimizer, lr, **opt_kwargs)
    return TrainState(model=model, optimizer=tx.init(model.parameters()))


def _pad_batch(images: np.ndarray, labels: np.ndarray, batch_size: int):
    n = images.shape[0]
    weights = np.zeros((batch_size,), np.float32)
    weights[:n] = 1.0
    if n < batch_size:
        pad = batch_size - n
        images = np.concatenate(
            [images, np.zeros((pad,) + images.shape[1:], images.dtype)], axis=0
        )
        labels = np.concatenate([labels, np.zeros((pad,), labels.dtype)], axis=0)
    return images, labels, weights


def _as_nhwc(images: np.ndarray) -> np.ndarray:
    """Accept NCHW (reference layout) or NHWC; the device side is NHWC."""
    if images.ndim == 4 and images.shape[1] in (1, 3) and images.shape[-1] not in (1, 3):
        return np.transpose(images, (0, 2, 3, 1))
    return images


def _to_numpy(x):
    if hasattr(x, "detach"):  # torch tensor from a reference-style loader
        x = x.detach().cpu().numpy()
    return np.asarray(x)


class _OneShotLoader:
    """Wraps a one-shot train iterator whose first batch was consumed by the
    shape probe: epoch 1 replays the probed batch then drains the iterator;
    any further epoch would silently see no data, so it raises instead."""

    def __init__(self, first, rest):
        self._first = first
        self._rest = rest
        self._used = False

    def __iter__(self):
        if self._used:
            raise RuntimeError(
                "train_loader is a one-shot iterator (generator) already "
                "exhausted by epoch 1; pass a re-iterable loader to train "
                "for more than one epoch."
            )
        self._used = True
        yield self._first
        yield from self._rest


def _progress(iterable, desc: str, unit: str, disable: bool):
    """tqdm where it is installed; otherwise the bare iterable."""
    if disable:
        return iterable, None
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable, None
    bar = tqdm(iterable, desc=desc, unit=unit)
    return bar, bar


def fit(
    model,
    train_loader: Iterable,
    test_loader: Iterable,
    epochs: int,
    val_loader: Optional[Iterable] = None,
    *,
    lr: float = 1e-4,
    optimizer: str = "adam",
    loss_fn: Optional[Callable] = None,
    seed: int = 0,
    mesh: Any = None,
    state: Optional[TrainState] = None,
    log_every: int = 50,
    verbose: bool = True,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    steps_per_call: int = 1,
    teacher_fn: Optional[Callable] = None,
    distill: Optional[Tuple[str, float, float]] = None,
    **opt_kwargs,
):
    """Train ``model`` on the device its parameters are on; returns the
    reference-parity metrics dict, plus ``final_state`` (model, optimizer
    and step count).

    Loaders are any iterables of (images, labels) numpy/torch batches; an
    optional ``loader.normalize = (mean, std)`` attribute moves normalization
    onto the device. ``seed`` seeds the model's dropout generator.
    ``steps_per_call > 1`` hands that many stacked batches to one call of
    the step function.
    """
    if mesh is not None:
        raise NotImplementedError(
            "training over a mesh is not ported yet (ROADMAP.md, queue 1, "
            "item 10: parallelism)")
    if checkpoint_dir:
        raise NotImplementedError(
            "checkpointing is not ported yet (ROADMAP.md, queue 1, item 5: "
            "utils/checkpoint.py)")
    if teacher_fn is not None or distill is not None:
        raise NotImplementedError(
            "distillation is not ported yet (ROADMAP.md, queue 1, item 5: "
            "utils/distillation_loss.py)")
    normalize = getattr(train_loader, "normalize", None)
    generator = getattr(model, "dropout_generator", None)
    if generator is not None:
        generator.manual_seed(seed)

    probe_it = iter(train_loader)
    first = next(probe_it)
    if probe_it is iter(train_loader):
        # One-shot iterator (a generator): iterating again won't replay the
        # probed batch. Restore it for epoch 1 and fail loudly if a second
        # epoch (which would silently see no data) is attempted.
        train_loader = _OneShotLoader(first, probe_it)
    batch_size = _as_nhwc(_to_numpy(first[0])).shape[0]

    if state is None:
        state = make_train_state(model, lr=lr, optimizer=optimizer,
                                 **opt_kwargs)
    device = _model_device(model)

    k = max(1, steps_per_call)
    if k == 1:
        train_step = train_step_fn(model, normalize, loss_fn)
        eval_step = eval_step_fn(model, normalize, loss_fn)
    else:
        train_step = multi_train_step_fn(model, normalize, loss_fn)
        eval_step = multi_eval_step_fn(model, normalize, loss_fn)

    def chunks(loader):
        """Yield (images, labels, weights) as host arrays stacked to
        (k, B, ...), or plain (B, ...) for k == 1; the epoch-tail chunk is
        padded with zero-weight batches."""
        buf = []
        for images, labels in loader:
            images = _as_nhwc(_to_numpy(images))
            labels = _to_numpy(labels)
            buf.append(_pad_batch(images, labels, batch_size))
            if len(buf) == k:
                yield buf[0] if k == 1 else [np.stack(t) for t in zip(*buf)]
                buf = []
        if buf:
            pad = buf[0]
            while len(buf) < k:
                buf.append(tuple(np.zeros_like(a) for a in pad))
            yield [np.stack(t) for t in zip(*buf)]

    def run_eval(loader):
        totals = torch.zeros(3, device=device)
        for images, labels, weights in chunks(loader):
            totals += torch.stack(eval_step(model, images, labels, weights))
        loss_sum, correct, count = totals.tolist()
        count = max(count, 1.0)
        return loss_sum / count, correct / count

    history = {
        "train_loss": [], "val_loss": [] if val_loader else None,
        "test_loss": [],
        "train_accuracy": [], "val_accuracy": [] if val_loader else None,
        "test_accuracy": [],
    }

    for epoch in range(epochs):
        totals = torch.zeros(3, device=device)
        it, bar = _progress(
            chunks(train_loader), f"Epoch {epoch + 1}/{epochs}",
            "batch" if k == 1 else f"x{k}batch", not verbose)
        for i, (images, labels, weights) in enumerate(it):
            state, l, c, n = train_step(state, images, labels, weights)
            totals += torch.stack((l, c, n))
            if bar is not None and i % log_every == log_every - 1:
                loss_sum, correct, count = totals.tolist()
                bar.set_postfix({"Train Loss": loss_sum / count,
                                 "Train Acc": correct / count})

        loss_sum, correct, count = totals.tolist()  # the epoch's one sync
        count = max(count, 1.0)
        epoch_train_loss = loss_sum / count
        epoch_train_acc = correct / count
        history["train_loss"].append(epoch_train_loss)
        history["train_accuracy"].append(epoch_train_acc)

        if val_loader is not None:
            vl, va = run_eval(val_loader)
            history["val_loss"].append(vl)
            history["val_accuracy"].append(va)
        else:
            vl, va = "N/A", "N/A"

        tl, ta = run_eval(test_loader)
        history["test_loss"].append(tl)
        history["test_accuracy"].append(ta)

        if verbose:
            print(
                f"Epoch {epoch + 1}/{epochs} - "
                f"Train Loss: {epoch_train_loss:.4f}, Train Acc: {epoch_train_acc:.4f}, "
                f"Val Loss: {vl}, Val Acc: {va}, "
                f"Test Loss: {tl:.4f}, Test Acc: {ta:.4f}"
            )

    model.eval()  # as the model was built: deterministic until trained again
    history["final_state"] = state
    return history
