"""Hungarian matcher for DETR set prediction.

Counterpart of ``vision_transformers_tpu/models/object_detection/
matcher.py``. The (B, Q, T) cost matrix — class, L1 and GIoU terms — is
computed on the model's device. The assignment has two backends:

- ``auction``: a Bertsekas auction on the device (Jacobi bidding rounds,
  ε-scaled bids, a greedy completion), batched over the images. The JAX
  package's ``while_loop`` is a Python loop here that asks the device
  whether every target is assigned only every 8 rounds (each
  question is a host synchronisation); a round after convergence changes
  nothing, so the answer is the same as checking every round.
- ``scipy``: exact ``linear_sum_assignment`` on the host (the test oracle).

``method="auto"`` keeps the JAX package's rule in the port's terms: the
auction where the cost lives on an accelerator (CUDA), scipy on the CPU.
Targets are padded to ``max_targets`` with a validity mask.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from vision_transformers_tpu_torch.utils.coco.util.box_ops import (
    box_cxcywh_to_xyxy,
    generalized_box_iou,
)

_NEG = -1e30
# auction rounds between two host checks for convergence
_CHECK_EVERY = 8


def prepare_targets(targets: Sequence[Dict], max_targets: int,
                    num_classes: int, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """List of per-image target dicts → padded tensors on ``device``:
    (labels (B, T) int64, boxes (B, T, 4) cxcywh-rel float32, valid (B, T)
    bool). Labels of padded slots are ``num_classes`` (no-object)."""
    b = len(targets)
    labels = np.full((b, max_targets), num_classes, np.int64)
    boxes = np.zeros((b, max_targets, 4), np.float32)
    valid = np.zeros((b, max_targets), bool)
    for i, t in enumerate(targets):
        n = min(len(t["labels"]), max_targets)
        labels[i, :n] = np.asarray(t["labels"])[:n]
        boxes[i, :n] = np.asarray(t["boxes"])[:n]
        valid[i, :n] = True
    return (torch.as_tensor(labels, device=device),
            torch.as_tensor(boxes, device=device),
            torch.as_tensor(valid, device=device))


def _host_assign(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Per-image linear sum assignment. cost (B, Q, T); returns (B, T)
    query index per target, -1 on padded slots."""
    from scipy.optimize import linear_sum_assignment

    b, q, t = cost.shape
    out = np.full((b, t), -1, np.int64)
    for i in range(b):
        n = int(valid[i].sum())
        if n == 0:
            continue
        rows, cols = linear_sum_assignment(cost[i, :, :n])
        out[i, cols] = rows
    return out


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Bool one-hot of the last axis; entries outside [0, n) give zeros."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def auction_assign(cost: torch.Tensor, valid: torch.Tensor,
                   eps_scale: float = 1e-3,
                   max_rounds: int = 512) -> torch.Tensor:
    """Near-optimal assignment for (B, Q, T) costs on their device.

    Bertsekas auction, Jacobi variant: every unassigned valid target bids
    for its best query simultaneously; per query, the highest bid wins.
    ε = spread·eps_scale/T gives optimal assignments for well-separated
    costs; ``max_rounds`` bounds the loop, after which any stragglers take
    their best *free* query greedily (always a valid matching). Each image
    runs as the JAX function runs it alone. Returns (B, T) int64 query
    index per target, -1 on invalid targets. A 2-D cost is one image."""
    if cost.ndim == 2:
        return auction_assign(cost[None], valid[None], eps_scale,
                              max_rounds)[0]
    b, q, t = cost.shape
    dev = cost.device
    benefit = -cost.float()                                  # maximise
    flat = benefit.reshape(b, -1)
    spread = (flat.amax(dim=1) - flat.amin(dim=1)).clamp_min(1e-6)
    eps = (spread * eps_scale / max(t, 1))[:, None]          # (B, 1)
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)
    arange_t = torch.arange(t, device=dev)
    benefit_t = benefit.transpose(1, 2)                      # (B, T, Q)

    prices = torch.zeros(b, q, dtype=torch.float32, device=dev)
    assign = torch.where(valid, -1, -2)  # -2: never assign   (B, T) int64

    def round_():
        nonlocal prices, assign
        unassigned = valid & (assign < 0)
        values = benefit_t - prices[:, None, :]              # (B, T, Q)
        best_v, best_q = values.max(dim=2)
        best_hot = _one_hot(best_q, q)
        second_v = torch.where(best_hot, neg, values).amax(dim=2)
        bid = torch.where(unassigned, best_v - second_v + eps, neg)
        bid_matrix = torch.where(unassigned[:, :, None] & best_hot,
                                 bid[:, :, None], neg)       # (B, T, Q)
        win_bid, winner = bid_matrix.max(dim=1)              # (B, Q)
        contested = win_bid > _NEG / 2
        held = assign.clamp_min(0)
        dethroned = (torch.gather(contested, 1, held) & (assign >= 0)
                     & (torch.gather(winner, 1, held) != arange_t))
        assign = torch.where(dethroned, -1, assign)
        prices = torch.where(contested, prices + win_bid, prices)
        won = (torch.gather(contested, 1, best_q)
               & (torch.gather(winner, 1, best_q) == arange_t) & unassigned)
        assign = torch.where(won, best_q, assign)

    rounds, done = 0, False
    while rounds < max_rounds and not done:
        for _ in range(min(_CHECK_EVERY, max_rounds - rounds)):
            round_()
            rounds += 1
        done = not bool((valid & (assign < 0)).any())  # one host sync

    # greedy completion for any stragglers, as the JAX function's t passes
    # (no-ops when every valid target is assigned, so skipped then)
    for _ in range(0 if done else t):
        taken = _one_hot(assign, q).any(dim=1)               # (B, Q)
        free = torch.where(taken[:, None, :], neg, benefit_t)
        need = valid & (assign < 0)
        pick_t = need.int().argmax(dim=1)                    # first unfilled
        row = torch.gather(free, 1, pick_t[:, None, None].expand(b, 1, q))
        choice = row[:, 0].argmax(dim=1)
        assign = torch.where(need & (arange_t == pick_t[:, None]),
                             choice[:, None], assign)
    return torch.where(valid, assign, -1)


@dataclass(frozen=True)
class HungarianMatcher:
    cost_class: float = 1.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    method: str = "auto"  # 'auto' | 'auction' | 'scipy'

    def cost(self, outputs: Dict, labels: torch.Tensor,
             boxes: torch.Tensor) -> torch.Tensor:
        """The (B, Q, T) matching cost, fp32, without gradient; non-finite
        entries are 1e6."""
        with torch.no_grad():
            logits = outputs["pred_logits"].float()
            pred_boxes = outputs["pred_boxes"].float()
            b, q, _ = logits.shape
            prob = torch.softmax(logits, dim=-1)             # (B, Q, C+1)
            cost_class = -torch.gather(
                prob, 2, labels[:, None, :].expand(b, q, labels.shape[1]))
            cost_bbox = (pred_boxes[:, :, None, :]
                         - boxes[:, None, :, :]).abs().sum(dim=-1)
            giou = generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes),
                                       box_cxcywh_to_xyxy(boxes))
            cost = (self.cost_class * cost_class + self.cost_bbox * cost_bbox
                    + self.cost_giou * (-giou))
            return torch.where(torch.isfinite(cost), cost,
                               torch.full_like(cost, 1e6))

    def __call__(self, outputs: Dict, labels: torch.Tensor,
                 boxes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """outputs: pred_logits (B, Q, C+1), pred_boxes (B, Q, 4 cxcywh).
        Returns src_idx (B, T) int64 on the outputs' device: the matched
        query per target, -1 for an invalid one."""
        cost = self.cost(outputs, labels, boxes)
        method = self.method
        if method == "auto":
            method = "auction" if cost.is_cuda else "scipy"
        if method == "auction":
            src_idx = auction_assign(cost, valid)
        elif method == "scipy":
            src_idx = torch.as_tensor(
                _host_assign(cost.cpu().numpy(), valid.cpu().numpy()),
                device=cost.device)
        else:
            raise ValueError(f"method {method!r}: 'auto', 'auction' or "
                             "'scipy'")
        return torch.where(valid, src_idx, -1)
