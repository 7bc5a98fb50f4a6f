"""Shared model base for the classification zoo.

Counterpart of ``vision_transformers_tpu/models/image_classification/
base.py``: there is exactly one trainer (``training/trainer.py``); this
mixin gives every model the reference's public
``train_model(model, train_loader, test_loader, epochs, val_loader)`` method
returning the same metrics dict ({train,val,test}_{loss,accuracy} lists).

The model trains on the device its parameters are on (the CUDA device
unless it was built with ``device="cpu"``).
"""

from __future__ import annotations

from typing import List, Optional

import torch


def draw_block_seeds(model, count: int) -> List[Optional[int]]:
    """``count`` seeds for one forward of ``model``, drawn on the host (no
    device synchronisation) from its ``dropout_generator``, in training mode
    when it has any dropout or stochastic depth (``model.has_dropout``);
    else ``count`` Nones. Every mask of a block is a function of its seed."""
    if not (model.training and model.has_dropout):
        return [None] * count
    return torch.randint(0, 2 ** 62, (count,),
                         generator=model.dropout_generator).tolist()


class TrainableModel:
    """Mixin: reference-parity train_model API on top of the shared trainer."""

    def train_model(self, model=None, train_loader=None, test_loader=None,
                    epochs: int = 1, val_loader=None, **kwargs):
        # The reference's signature passes the model explicitly even though
        # it is always `self`; accept and ignore it for drop-in compatibility.
        from vision_transformers_tpu_torch.training.trainer import fit

        return fit(self, train_loader=train_loader, test_loader=test_loader,
                   epochs=epochs, val_loader=val_loader, **kwargs)
