"""DETR set criterion.

Counterpart of ``vision_transformers_tpu/models/object_detection/
criterion.py``: the standard DETR losses over the Hungarian matching, on
padded targets:

- ``loss_labels``: CE over every query against its matched class or
  no-object, no-object down-weighted by ``eos_coef`` (0.1), weighted-mean
  normalisation;
- ``loss_boxes``: L1 on cxcywh + (1 − GIoU) on matched pairs, normalised by
  the number of target boxes (``num_boxes`` overrides it);
- ``cardinality_error``: |#non-empty predictions − #targets| (no gradient);
- aux losses: the same terms per intermediate decoder layer, suffixed
  ``_{i}``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from vision_transformers_tpu_torch.models.object_detection.matcher import (
    HungarianMatcher,
)
from vision_transformers_tpu_torch.utils.coco.util.box_ops import (
    box_cxcywh_to_xyxy,
    generalized_box_iou,
)


def _gather_matched(arr: torch.Tensor, src_idx: torch.Tensor) -> torch.Tensor:
    """arr (B, Q, K), src_idx (B, T) → (B, T, K); invalid rows gather query
    0 (callers mask them)."""
    safe = src_idx.clamp_min(0)
    return torch.gather(arr, 1, safe[..., None].expand(*safe.shape,
                                                       arr.shape[-1]))


@dataclass(frozen=True)
class SetCriterion:
    num_classes: int
    matcher: HungarianMatcher = field(default_factory=HungarianMatcher)
    eos_coef: float = 0.1
    weight_ce: float = 1.0
    weight_bbox: float = 5.0
    weight_giou: float = 2.0

    def _losses_one(self, outputs: Dict, labels, boxes, valid,
                    num_boxes) -> Dict[str, torch.Tensor]:
        src_idx = self.matcher(outputs, labels, boxes, valid)
        logits = outputs["pred_logits"].float()
        pred_boxes = outputs["pred_boxes"].float()
        b, q, _ = logits.shape

        # labels: scatter matched classes into a (B, Q) target map; slot q
        # takes the invalid targets and is dropped
        matched = valid & (src_idx >= 0)
        scatter_idx = torch.where(matched, src_idx, q)
        target = torch.full((b, q + 1), self.num_classes, dtype=torch.long,
                            device=logits.device)
        target.scatter_(1, scatter_idx, labels.long())
        target_classes = target[:, :q]

        ce = F.cross_entropy(logits.transpose(1, 2), target_classes,
                             reduction="none")
        w = torch.where(target_classes == self.num_classes,
                        torch.full_like(ce, self.eos_coef),
                        torch.ones_like(ce))
        loss_ce = (ce * w).sum() / w.sum().clamp_min(1e-9)

        # boxes: matched pairs only
        matched_pred = _gather_matched(pred_boxes, src_idx)   # (B, T, 4)
        vmask = matched.float()
        l1 = (matched_pred - boxes).abs().sum(dim=-1)
        loss_bbox = (l1 * vmask).sum() / num_boxes
        giou = generalized_box_iou(box_cxcywh_to_xyxy(matched_pred),
                                   box_cxcywh_to_xyxy(boxes))
        giou_diag = torch.diagonal(giou, dim1=-2, dim2=-1)
        loss_giou = ((1.0 - giou_diag) * vmask).sum() / num_boxes

        # cardinality (no gradient; logging)
        with torch.no_grad():
            pred_nonempty = (logits.argmax(dim=-1) != self.num_classes).sum(
                dim=1)
            card = (pred_nonempty.float() - valid.sum(dim=1).float()).abs() \
                .mean()
        return {"loss_ce": loss_ce, "loss_bbox": loss_bbox,
                "loss_giou": loss_giou, "cardinality_error": card}

    def __call__(self, outputs: Dict, labels, boxes, valid,
                 num_boxes: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
        """outputs from Detr; (labels, boxes, valid) from
        ``prepare_targets``. ``num_boxes`` overrides the normaliser."""
        if num_boxes is None:
            num_boxes = valid.float().sum().clamp_min(1.0)
        losses = self._losses_one(outputs, labels, boxes, valid, num_boxes)
        for i, aux in enumerate(outputs.get("aux_outputs", ())):
            for k, v in self._losses_one(aux, labels, boxes, valid,
                                         num_boxes).items():
                losses[f"{k}_{i}"] = v
        return losses

    def total_loss(self, losses: Dict[str, torch.Tensor]) -> torch.Tensor:
        weights = {"loss_ce": self.weight_ce, "loss_bbox": self.weight_bbox,
                   "loss_giou": self.weight_giou}
        total = 0.0
        for k, v in losses.items():
            base = k.rsplit("_", 1)[0] if k[-1].isdigit() else k
            if base in weights:
                total = total + weights[base] * v
        return total
