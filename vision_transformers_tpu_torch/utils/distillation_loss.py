"""Knowledge-distillation loss (DeiT-style).

Counterpart of ``vision_transformers_tpu/utils/distillation_loss.py``, with
the semantics of the reference's vendored DistillationLoss
(utils/distillation_loss.py:14-75):

- ``soft``: KL(log_softmax(student_kd/τ) ‖ log_softmax(teacher/τ)) · τ² /
  numel (the "legacy PyTorch" numel normalisation, :55-67);
- ``hard``: CE(student_kd, argmax(teacher)) (:71-72);
- blend: base·(1−α) + distill·α (:74).

The teacher's logits are detached (the reference runs the teacher under
``torch.no_grad``, :52-53). ``DistillationLoss(base_criterion,
teacher_model, distillation_type, alpha, tau)(inputs, outputs, labels)``
keeps the reference's call surface.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def soft_distillation(student_kd: torch.Tensor, teacher_logits: torch.Tensor,
                      tau: float) -> torch.Tensor:
    t = tau
    log_p = F.log_softmax(student_kd.float() / t, dim=1)
    log_q = F.log_softmax(teacher_logits.float() / t, dim=1)
    # KL(q ‖ p) summed, scaled τ², divided by the student's numel (legacy)
    kl = torch.sum(torch.exp(log_q) * (log_q - log_p))
    return kl * (t * t) / student_kd.numel()


def hard_distillation(student_kd: torch.Tensor,
                      teacher_logits: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(student_kd.float(), teacher_logits.argmax(dim=1))


def distillation_loss(base_loss: torch.Tensor,
                      student_kd: Optional[torch.Tensor],
                      teacher_logits: Optional[torch.Tensor],
                      distillation_type: str = "hard", alpha: float = 0.5,
                      tau: float = 5.0) -> torch.Tensor:
    if distillation_type not in ("none", "soft", "hard"):
        raise ValueError(f"distillation_type {distillation_type!r}: one of "
                         "'none', 'soft', 'hard'")
    if distillation_type == "none":
        return base_loss
    if student_kd is None:
        raise ValueError(
            "When knowledge distillation is enabled, the model is expected "
            "to return a Tuple[cls_logits, dist_logits]")
    teacher_logits = teacher_logits.detach()
    if distillation_type == "soft":
        dist = soft_distillation(student_kd, teacher_logits, tau)
    else:
        dist = hard_distillation(student_kd, teacher_logits)
    return base_loss * (1.0 - alpha) + dist * alpha


class DistillationLoss:
    """Reference-call-surface wrapper. ``teacher_model`` is a callable
    images → logits (a module in eval mode, say)."""

    def __init__(self, base_criterion: Callable, teacher_model: Callable,
                 distillation_type: str, alpha: float, tau: float):
        if distillation_type not in ("none", "soft", "hard"):
            raise ValueError(f"distillation_type {distillation_type!r}")
        self.base_criterion = base_criterion
        self.teacher_model = teacher_model
        self.distillation_type = distillation_type
        self.alpha = alpha
        self.tau = tau

    def __call__(self, inputs, outputs, labels):
        outputs_kd = None
        if isinstance(outputs, (tuple, list)):
            outputs, outputs_kd = outputs
        base = self.base_criterion(outputs, labels)
        if self.distillation_type == "none":
            return base
        with torch.no_grad():
            teacher_logits = self.teacher_model(inputs)
        return distillation_loss(base, outputs_kd, teacher_logits,
                                 self.distillation_type, self.alpha, self.tau)
