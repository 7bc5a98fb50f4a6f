"""Weights from the JAX package's ViT into this port's modules.

``vit_state_dict_from_jax(params)`` takes the JAX ViT's params tree as
nested dicts of numpy arrays (``jax.device_get(params)`` gives that) and
returns the port's ``state_dict``. The port's module names mirror the JAX
tree, so the mapping is a rename and a transpose:

- Dense ``kernel`` (in, out) → Linear ``weight`` (out, in);
- LayerNorm ``scale`` → ``weight``;
- every other leaf (``bias``, ``class_token``, ``pos_embedding``) as it is.

Loading reference or torchvision checkpoints is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def vit_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], prefix: str) -> None:
        for key, sub in tree.items():
            if isinstance(sub, Mapping):
                walk(sub, f"{prefix}{key}.")
                continue
            arr = np.asarray(sub, dtype=np.float32)
            if key == "kernel":
                key, arr = "weight", arr.T
            elif key == "scale":
                key = "weight"
            out[prefix + key] = torch.tensor(arr)  # a copy: jax arrays are read-only

    walk(params, "")
    return out
