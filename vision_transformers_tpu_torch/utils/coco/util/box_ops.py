"""Bounding-box math for the detection stack.

Counterpart of ``vision_transformers_tpu/utils/coco/util/box_ops.py``, in
PyTorch: cxcywh↔xyxy conversion, IoU with union, generalized IoU (the DETR
box-loss core), masks→boxes. Degenerate boxes are clamped rather than
rejected (the criterion calls ``generalized_box_iou`` on every prediction);
``check=True`` validates instead. The pairwise functions also take leading
batch dimensions: (..., N, 4) against (..., M, 4) → (..., N, M).
"""

from __future__ import annotations

from typing import Tuple

import torch


def box_cxcywh_to_xyxy(x: torch.Tensor) -> torch.Tensor:
    xc, yc, w, h = x.unbind(-1)
    return torch.stack(
        [xc - 0.5 * w, yc - 0.5 * h, xc + 0.5 * w, yc + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(x: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = x.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0],
                       dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise IoU and union for xyxy boxes: (N,4),(M,4) → (N,M),(N,M)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union.clamp_min(1e-9), union


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                        check: bool = False) -> torch.Tensor:
    """Pairwise GIoU for xyxy boxes (giou.stanford.edu). ``check`` raises
    ``ValueError`` on a box whose corners are out of order."""
    if check:
        for name, b in (("boxes1", boxes1), ("boxes2", boxes2)):
            if not bool((b[..., 2:] >= b[..., :2]).all()):
                raise ValueError(f"{name}: x1 < x0 or y1 < y0")
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp_min(1e-9)


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """(N, H, W) boolean/0-1 masks → (N, 4) xyxy boxes."""
    if masks.numel() == 0:
        return torch.zeros((0, 4), dtype=torch.float32, device=masks.device)
    n, h, w = masks.shape
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)[None, :]
    m = masks.float()
    big = torch.full((), 1e8, device=masks.device)
    x_max = (m * xs).reshape(n, -1).amax(dim=-1)
    x_min = torch.where(m > 0, xs, big).reshape(n, -1).amin(dim=-1)
    y_max = (m * ys).reshape(n, -1).amax(dim=-1)
    y_min = torch.where(m > 0, ys, big).reshape(n, -1).amin(dim=-1)
    return torch.stack([x_min, y_min, x_max, y_max], dim=1)
