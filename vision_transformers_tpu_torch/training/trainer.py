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
- ``checkpoint_dir`` / ``checkpoint_every``: the state is saved every that
  many epochs (``utils/checkpoint.py``); ``teacher_fn`` / ``distill``:
  DeiT-style distillation (``utils/distillation_loss.py``).

What differs: PyTorch runs eagerly, so there is no jit and no donated
state; the model and the optimizer are updated in place and a
``TrainState`` just holds them with the step count. Dropout randomness
comes from the model's own generator, which ``fit(seed=...)`` seeds, not
from a key passed to each step.

``mesh`` (``parallel.make_mesh``, a mesh of ranks): every rank reads the
same global batch and runs its slice of the batch axis over ``data``; the
outputs are gathered, so every rank computes the loss of the whole batch
(a global weighted mean, padded rows included) and the same metrics, and
the gradients are summed over ``data`` in one all-reduce. A ``model``
axis larger than 1 first shards the parameters (``parallel.shard_params``,
Megatron TP) and then builds the optimizer from the shards, so Adam steps
on each rank's own slices; gradient clipping takes the norm over the
whole model. A checkpoint is the file a run without a mesh writes: TP
shards are gathered and rank 0 writes it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vision_transformers_tpu_torch.parallel import mesh as pmesh
from vision_transformers_tpu_torch.training.optimizers import (
    Optimizer,
    make_optimizer,
)
from vision_transformers_tpu_torch.utils.checkpoint import save_checkpoint
from vision_transformers_tpu_torch.utils.distillation_loss import (
    distillation_loss,
)
from vision_transformers_tpu_torch.utils.metrics import span


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


def refuse_serving_only(model) -> None:
    """A ``quant8`` model holds int8 weights for serving (``ops/quant.py``,
    as JAX ``QuantDense``): no training path takes it."""
    if getattr(model, "quant8", False):
        raise ValueError(
            f"{type(model).__name__}(quant8=True) is a serving-only model "
            "(int8 weights): train the float model, then quantize it with "
            "serving.quantize_classifier")


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _to_device(device, images, labels, weights):
    return (torch.as_tensor(images, device=device),
            torch.as_tensor(labels, device=device).long(),
            torch.as_tensor(weights, device=device).float())


def _data_parallel(mesh):
    return None if mesh is None else pmesh.DataParallel(mesh, "data")


def _forward(fn, x, dp):
    """``fn(x)``, or under data parallelism ``fn`` of this rank's rows with
    the outputs (a tensor or a tuple of them) gathered whole."""
    if dp is None:
        return fn(x)
    out = fn(dp.local(x))
    if isinstance(out, tuple):
        return tuple(dp.gather(o) for o in out)
    return dp.gather(out)


def train_step_fn(model, normalize=None, loss_fn=None, teacher_fn=None,
                  distill=None, mesh=None):
    """Build the train step for a classification model:
    ``step(state, images, labels, weights)`` → (state, loss·n, correct, n),
    the last three as scalars on the model's device. Inputs may be numpy
    arrays or tensors; they are moved to the model's device. A ``quant8``
    model raises ``ValueError`` (``refuse_serving_only``). Spans
    (``utils.metrics.span``, ordinal: ``state.step`` before the step):
    ``vtt.train.step`` over the step, and in it ``vtt.train.input``,
    ``vtt.train.forward`` (the teacher and the loss too),
    ``vtt.train.backward`` (``zero_grad`` and ``backward``),
    ``vtt.train.allreduce`` (under a mesh) and ``vtt.train.optimizer``.

    ``teacher_fn`` (normalised images → logits) enables DeiT-style
    distillation: the model's training forward must return (cls_logits,
    dist_logits), and ``distill`` = (type, alpha, tau) (default ("hard",
    0.5, 5.0)) blends the base loss with the distillation term; accuracy is
    the class head's. ``mesh``: the step of ``fit(mesh=...)`` (the module
    docstring); the inputs are the whole batch on every rank."""
    refuse_serving_only(model)
    loss_fn = loss_fn or cross_entropy_with_weights
    dp = _data_parallel(mesh)
    generator = getattr(model, "dropout_generator", None)

    def step(state: TrainState, images, labels, weights):
        with span("vtt.train.step", state.step):
            with span("vtt.train.input"):
                images, labels, weights = _to_device(
                    _model_device(model), images, labels, weights)
                x = _default_preprocess(images, normalize)
            model.train()
            with span("vtt.train.forward"):
                if dp is None:
                    out = model(x)
                else:
                    with dp.seeded(generator):
                        out = _forward(model, x, dp)
                if teacher_fn is not None:
                    if not isinstance(out, tuple):
                        raise ValueError(
                            "distillation needs a model whose training "
                            "forward returns (cls_logits, dist_logits), as "
                            "DeiT's does with distilled_training=True")
                    logits, dist_logits = out
                    with torch.no_grad():
                        teacher_logits = _forward(teacher_fn, x, dp)
                    kind, alpha, tau = distill or ("hard", 0.5, 5.0)
                    loss = distillation_loss(
                        loss_fn(logits, labels, weights), dist_logits,
                        teacher_logits, kind, alpha, tau)
                else:
                    logits = out
                    loss = loss_fn(logits, labels, weights)
            with span("vtt.train.backward"):
                state.optimizer.zero_grad()
                loss.backward()
            if dp is not None:
                with span("vtt.train.allreduce"):
                    dp.all_reduce_grads(state.optimizer.params)
            with span("vtt.train.optimizer"):
                state.optimizer.step()
            state.step += 1
            with torch.no_grad():
                pred = logits.argmax(dim=-1)
                correct = ((pred == labels) * weights).sum()
                n = weights.sum()
                return state, loss.detach() * n, correct, n

    return step


def eval_step_fn(model, normalize=None, loss_fn=None, mesh=None):
    """``step(model, images, labels, weights)`` → (loss·n, correct, n) in
    eval mode, without gradients (``mesh`` as ``train_step_fn``'s)."""
    loss_fn = loss_fn or cross_entropy_with_weights
    dp = _data_parallel(mesh)

    @torch.no_grad()
    def step(model_, images, labels, weights):
        images, labels, weights = _to_device(_model_device(model_), images,
                                             labels, weights)
        x = _default_preprocess(images, normalize)
        model_.eval()
        logits = _forward(model_, x, dp)
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


def multi_train_step_fn(model, normalize=None, loss_fn=None, teacher_fn=None,
                        distill=None, mesh=None):
    """k steps per call over batches stacked to (k, B, ...): a Python loop
    (PyTorch runs eagerly; there is no scan to amortise). A batch whose
    weights are all 0 (an epoch-tail filler) is skipped. Pass ``weights``
    as a numpy array and that test costs no device synchronisation."""
    step = train_step_fn(model, normalize, loss_fn, teacher_fn, distill,
                         mesh)

    def multi(state: TrainState, images, labels, weights):
        results = []
        for im, lb, w in zip(images, labels, weights):
            if float(w.sum()) > 0:
                state, l, c, n = step(state, im, lb, w)
                results.append((l, c, n))
        return (state, *_sum_steps(results, _model_device(model)))

    return multi


def multi_eval_step_fn(model, normalize=None, loss_fn=None, mesh=None):
    step = eval_step_fn(model, normalize, loss_fn, mesh)

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
    the step function. ``checkpoint_dir`` with ``checkpoint_every`` = n
    saves the state after every n-th epoch as step ``epoch``
    (``utils.checkpoint.save_checkpoint``). ``teacher_fn`` and ``distill``
    as ``train_step_fn``'s. ``mesh``: DP over its ``data`` axis and TP over
    its ``model`` axis (the module docstring); the batch size must divide
    the ``data`` axis, and a ``state`` passed in under TP must hold a model
    that ``parallel.shard_params`` sharded.
    """
    tp_active = (mesh is not None
                 and pmesh.check_mesh(mesh).shape.get("model", 1) > 1)
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
    if mesh is not None and "data" in mesh.shape \
            and batch_size % mesh.shape["data"]:
        raise ValueError(f"batch size {batch_size} does not split over the "
                         f"mesh's data axis of {mesh.shape['data']}")

    if state is None:
        if tp_active:
            # shard first, then build the optimizer from the shards, so
            # its moments are each rank's slices (JAX trainer.py:300-317)
            pmesh.shard_params(model, mesh)
        state = make_train_state(model, lr=lr, optimizer=optimizer,
                                 **opt_kwargs)
    elif tp_active and not pmesh.is_tp_sharded(model):
        raise ValueError("under a model axis, pass state=None (fit shards "
                         "the model) or the state of a model that "
                         "parallel.shard_params sharded")
    device = _model_device(model)

    k = max(1, steps_per_call)
    if k == 1:
        train_step = train_step_fn(model, normalize, loss_fn, teacher_fn,
                                   distill, mesh)
        eval_step = eval_step_fn(model, normalize, loss_fn, mesh)
    else:
        train_step = multi_train_step_fn(model, normalize, loss_fn,
                                         teacher_fn, distill, mesh)
        eval_step = multi_eval_step_fn(model, normalize, loss_fn, mesh)

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

        if checkpoint_dir and checkpoint_every and \
                (epoch + 1) % checkpoint_every == 0:
            save_checkpoint(
                checkpoint_dir,
                pmesh.gather_train_state(state) if tp_active else state,
                step=epoch + 1)

    model.eval()  # as the model was built: deterministic until trained again
    history["final_state"] = state
    return history
