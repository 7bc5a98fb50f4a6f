"""Detection training and evaluation loop (DETR).

Counterpart of ``vision_transformers_tpu/training/detection.py``:

- ``DetectionLoader``: batches a map-style detection dataset with the DETR
  collate (padded ``NestedTensor``, bucketed shapes) behind a prefetch
  thread, shuffled per epoch from ``seed + epoch``.
- ``fit_detection``: forward, Hungarian matching (the auction on the card,
  scipy on the CPU), the set loss, and the DETR recipe's optimizer: AdamW
  per label — ``main`` at ``lr``, ``backbone`` (every parameter under
  ``joiner.backbone``) at ``lr_backbone`` — each group clipped to its own
  global norm, as ``optax.multi_transform`` of two ``chain``s does;
  ``lr_drop`` multiplies both rates by 0.1 from update
  ``len(loader)·lr_drop`` on (optax's ``piecewise_constant_schedule``).
  MetricLogger loss logging and per-epoch COCO evaluation.
- ``evaluate_model``: predictions → ``PostProcess`` → ``evaluate_detections``.

PyTorch runs eagerly: there is no jitted step and no donated state; the
model and its two optimizers are updated in place. Dropout seeds come from
the model's ``dropout_generator``, which ``seed`` seeds.

``fit_detection(mesh=...)`` is data parallelism over the mesh's ``data``
axis: the model and optimizer state are whole on every rank, each rank runs
its slice of the batch, the outputs are gathered so every rank matches and
weighs the whole batch (the loss is the same on every rank), and the
gradients are summed over ``data`` before the clipped update. A batch that
does not divide the axis (a ragged final bucket) runs whole on every rank,
unsplit, as the JAX package keeps it replicated.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from vision_transformers_tpu_torch.core.dtypes import resolve_device
from vision_transformers_tpu_torch.models.object_detection.criterion import (
    SetCriterion,
)
from vision_transformers_tpu_torch.models.object_detection.detr import (
    PostProcess,
)
from vision_transformers_tpu_torch.models.object_detection.matcher import (
    prepare_targets,
)
from vision_transformers_tpu_torch.parallel.mesh import DataParallel
from vision_transformers_tpu_torch.training.optimizers import (
    Optimizer,
    make_optimizer,
)
from vision_transformers_tpu_torch.training.trainer import TrainState
from vision_transformers_tpu_torch.utils.coco.coco_eval import (
    evaluate_detections,
)
from vision_transformers_tpu_torch.utils.coco.util.misc import (
    nested_tensor_from_tensor_list,
)
from vision_transformers_tpu_torch.utils.metrics import (
    MetricLogger,
    SmoothedValue,
)


class DetectionLoader:
    """Re-iterable batched loader over a map-style detection dataset;
    batches are padded to multiples of ``size_bucket`` (the JAX loader
    stores it and pads to 128 whatever it is)."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, size_bucket: int = 128, prefetch: int = 2,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.size_bucket = size_bucket
        self.prefetch = prefetch
        self.drop_last = drop_last
        self._seed = seed
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _produce(self, q, rng):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(order)
        try:
            stop = (len(order) // self.batch_size * self.batch_size
                    if self.drop_last else len(order))
            for i in range(0, stop, self.batch_size):
                idx = order[i:i + self.batch_size]
                images, targets = zip(*(self.dataset[int(j)] for j in idx))
                q.put((nested_tensor_from_tensor_list(images,
                                                      self.size_bucket),
                       targets))
        finally:
            q.put(None)

    def __iter__(self):
        self._epoch += 1
        rng = np.random.RandomState(self._seed + self._epoch)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=self._produce, args=(q, rng), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            yield item
        t.join()


class DetectionOptimizer:
    """The per-label optimizers of ``fit_detection``, stepped together:
    ``groups`` maps a label ("main", "backbone") to an ``Optimizer`` bound
    to that label's parameters."""

    def __init__(self, groups: Dict[str, Optimizer]):
        self.groups = groups

    def zero_grad(self) -> None:
        for tx in self.groups.values():
            tx.zero_grad()

    def step(self) -> None:
        for tx in self.groups.values():
            tx.step()


def make_detection_optimizer(model: torch.nn.Module, *, lr: float,
                             lr_backbone: Optional[float], weight_decay: float,
                             grad_clip: float,
                             lr_drop_step: Optional[int] = None
                             ) -> DetectionOptimizer:
    """AdamW with its own global-norm clip per label (one chain for all
    parameters when ``lr_backbone`` is None), every parameter included —
    ``FrozenBatchNorm``'s leaves too, which take no gradient and are only
    decayed, as ``optax.adamw`` decays every leaf. From update
    ``lr_drop_step`` on, each rate is multiplied by 0.1."""

    def adamw(base: float) -> Optimizer:
        schedule = None
        if lr_drop_step is not None:
            def schedule(count: int, base: float = base) -> float:
                return base * (0.1 if count >= lr_drop_step else 1.0)
        return make_optimizer("adamw", base, weight_decay=weight_decay,
                              grad_clip_norm=grad_clip, schedule=schedule)

    params = dict(model.named_parameters())
    if lr_backbone is None:
        return DetectionOptimizer({"main": adamw(lr).init(params.values())})
    groups = {}
    for label, base in (("main", lr), ("backbone", lr_backbone)):
        # the backbone's parameters take the DETR recipe's lower rate
        members = [p for n, p in params.items()
                   if ("backbone" in n) == (label == "backbone")]
        if members:
            groups[label] = adamw(base).init(members)
    return DetectionOptimizer(groups)


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def fit_detection(
    model,
    train_loader: Iterable,
    epochs: int,
    *,
    val_loader: Optional[Iterable] = None,
    num_classes: int,
    max_targets: int = 64,
    lr: float = 1e-4,
    lr_backbone: Optional[float] = 1e-5,
    lr_drop: Optional[int] = None,
    weight_decay: float = 1e-4,
    grad_clip: float = 0.1,
    criterion: Optional[SetCriterion] = None,
    seed: int = 0,
    print_freq: int = 50,
    state: Optional[TrainState] = None,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    verbose: bool = True,
    mesh=None,
):
    """Train DETR on the device its parameters are on; returns
    {'loss': [...per-epoch mean...], 'metrics': [...per-epoch COCO
    metrics...], 'final_state': TrainState}.

    ``init_params``: a ``state_dict`` loaded (``strict=True``) before
    training, e.g. from ``utils.port_jax.detr_state_dict_from_jax``.
    ``state``: a ``TrainState`` of this model to continue from. ``lr_drop``
    needs a sized loader. ``mesh``: data parallelism over its ``data``
    axis (the module docstring)."""
    dp = None if mesh is None else DataParallel(mesh, "data")
    criterion = criterion or SetCriterion(num_classes=num_classes)
    device = _model_device(model)
    if init_params is not None:
        model.load_state_dict(init_params)
    if state is None:
        lr_drop_step = (None if lr_drop is None
                        else len(train_loader) * lr_drop)
        state = TrainState(model, make_detection_optimizer(
            model, lr=lr, lr_backbone=lr_backbone, weight_decay=weight_decay,
            grad_clip=grad_clip, lr_drop_step=lr_drop_step))
    model.dropout_generator.manual_seed(seed)

    post = PostProcess()
    history: Dict[str, list] = {"loss": [], "metrics": []}

    for epoch in range(epochs):
        logger = MetricLogger()
        logger.add_meter("loss", SmoothedValue(fmt="{median:.4f}"))
        epoch_losses: List[torch.Tensor] = []
        it = (logger.log_every(train_loader, print_freq,
                               header=f"Epoch [{epoch}]")
              if verbose else train_loader)
        for nt, targets in it:
            loss, losses = train_step(state, criterion, nt, targets,
                                      max_targets, num_classes, dp)
            # the loss stays on the device; non-verbose runs read it once
            # per epoch
            epoch_losses.append(loss)
            if verbose:
                logger.update(loss=float(loss),
                              loss_ce=float(losses["loss_ce"]),
                              loss_bbox=float(losses["loss_bbox"]),
                              loss_giou=float(losses["loss_giou"]))
        history["loss"].append(
            float(torch.stack(epoch_losses).float().mean()))

        if val_loader is not None:
            metrics = evaluate_model(model, val_loader, post, device=device)
            history["metrics"].append(metrics)
            if verbose:
                print(f"Epoch [{epoch}] eval: {metrics}")

    history["final_state"] = state
    return history


def _gather_outputs(out, dp):
    """DETR's output dict (tensors, lists of dicts of them) with every
    tensor's batch rows gathered from the ranks."""
    if isinstance(out, dict):
        return {k: _gather_outputs(v, dp) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_gather_outputs(v, dp) for v in out)
    return dp.gather(out)


def train_step(state: TrainState, criterion: SetCriterion, nt, targets,
               max_targets: int, num_classes: int, dp=None):
    """One step on a collated batch: forward in training mode, matching,
    set loss, backward, the optimizers' update. Returns (total loss, loss
    dict), detached, on the model's device. ``dp``: the ``DataParallel`` of
    ``fit_detection(mesh=...)``."""
    model = state.model
    device = _model_device(model)
    labels, boxes, valid = prepare_targets(targets, max_targets, num_classes,
                                           device)
    batch = nt.to(device)
    model.train()
    split = dp is not None and dp.divides(batch.tensors.shape[0])
    if split:
        with dp.seeded(model.dropout_generator):
            out = model(dp.local(batch.tensors), dp.local(batch.mask))
        out = _gather_outputs(out, dp)
    else:
        out = model(batch.tensors, batch.mask)
    losses = criterion(out, labels, boxes, valid)
    loss = criterion.total_loss(losses)
    state.optimizer.zero_grad()
    loss.backward()
    if split:
        dp.all_reduce_grads(p for p in model.parameters() if p.requires_grad)
    state.optimizer.step()
    state.step += 1
    return loss.detach(), {k: v.detach() for k, v in losses.items()}


def _eval_forward(model: torch.nn.Module) -> Callable:
    @torch.no_grad()
    def predict(images, mask):
        model.eval()
        return model(images, mask)
    return predict


def evaluate_model(predict_fn, loader, post: Optional[PostProcess] = None, *,
                   device=None) -> Dict[str, float]:
    """Detection eval: predictions + ground truth → COCO metrics.

    ``predict_fn(images, mask)`` takes the batch as tensors on ``device``
    (CUDA unless given; a ``torch.nn.Module`` is run in eval mode without
    gradients) and returns DETR's output dict."""
    post = post or PostProcess()
    device = resolve_device(device)
    if isinstance(predict_fn, torch.nn.Module):
        predict_fn = _eval_forward(predict_fn)
    gts, preds = {}, {}
    for nt, targets in loader:
        batch = nt.to(device)
        out = predict_fn(batch.tensors, batch.mask)
        sizes = torch.as_tensor(
            np.stack([np.asarray(t["orig_size"]) for t in targets]),
            dtype=torch.float32)
        results = post(out, sizes)
        for t, r in zip(targets, results):
            img_id = int(np.asarray(t["image_id"]).reshape(-1)[0])
            # GT boxes are rel-cxcywh after Normalize → abs xyxy
            h, w = np.asarray(t["orig_size"])
            b = np.asarray(t["boxes"], np.float64)
            if b.size:
                cx, cy, bw, bh = b.T
                gt_boxes = np.stack([
                    (cx - bw / 2) * w, (cy - bh / 2) * h,
                    (cx + bw / 2) * w, (cy + bh / 2) * h], axis=1)
            else:
                gt_boxes = np.zeros((0, 4))
            gts[img_id] = {"boxes": gt_boxes,
                           "labels": np.asarray(t["labels"])}
            preds[img_id] = {
                "boxes": r["boxes"].double().cpu().numpy(),
                "labels": r["labels"].cpu().numpy(),
                "scores": r["scores"].double().cpu().numpy(),
            }
    return evaluate_detections(gts, preds)
