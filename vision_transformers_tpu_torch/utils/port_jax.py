"""Weights from the JAX package's models into this port's modules.

``vit_state_dict_from_jax(params)`` and ``swin_state_dict_from_jax(params)``
take a JAX model's params tree as nested dicts of numpy arrays
(``jax.device_get(params)`` gives that) and return the port's
``state_dict``. The port's module names mirror the JAX tree, so the mapping
is a rename and a transpose:

- Dense ``kernel`` (in, out) → Linear ``weight`` (out, in);
- a conv ``kernel`` (ph, pw, cin, out), Swin's patch embedding → the
  ``weight`` (out, ph·pw·cin) of the matmul that ``patchify`` feeds, whose
  features are ordered (ph, pw, c) too;
- LayerNorm ``scale`` → ``weight``;
- every other leaf as it is: ``bias``, ``class_token``, ``pos_embedding``,
  and the window attention's raw parameters, which keep flax's (in, out)
  layout in the port (``qkv_kernel``, ``proj_kernel``, ``qkv_bias``,
  ``relative_position_bias_table``; SwinV2's ``q_bias``, ``v_bias``,
  ``logit_scale``).

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
                key, arr = "weight", arr.reshape(-1, arr.shape[-1]).T
            elif key == "scale":
                key = "weight"
            out[prefix + key] = torch.tensor(arr)  # a copy: jax arrays are read-only

    walk(params, "")
    return out


def swin_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``SwinTransformer`` / ``SwinTransformerV2`` params → the port's
    ``state_dict`` (loads with ``strict=True``). The same walk as the ViT's:
    the tree's names are the port's module names."""
    return vit_state_dict_from_jax(params)
