"""Weights from the JAX package's models into this port's modules.

``vit_state_dict_from_jax(params)``, ``swin_state_dict_from_jax(params)``,
``pvt_state_dict_from_jax(params)``, ``twins_state_dict_from_jax(params)``,
``deit_state_dict_from_jax(params)``, ``cpevit_state_dict_from_jax(params)``,
``t2t_state_dict_from_jax(params)``, ``cpvt_state_dict_from_jax(params)``,
``tnt_state_dict_from_jax(params)`` and ``detr_state_dict_from_jax(params)``
take a JAX model's params tree as nested dicts of numpy arrays
(``jax.device_get(params)`` gives that) and return the port's
``state_dict``. The port's module names mirror the JAX tree, so the mapping
is a rename and a transpose:

- Dense ``kernel`` (in, out) → Linear ``weight`` (out, in); a quantized
  ViT's ``QuantDense`` ``kernel_q`` (int8, (in, out)) → its int8 (out, in)
  ``kernel_q``, with ``kernel_scale`` and ``bias`` in fp32;
- a conv ``kernel`` (ph, pw, cin, out), Swin's patch embedding → the
  ``weight`` (out, ph·pw·cin) of the matmul that ``patchify`` feeds, whose
  features are ordered (ph, pw, c) too;
- Twins', CPE-ViT's and CPVT's depthwise conv ``kernel`` (3, 3, 1, C) →
  ``F.conv2d``'s ``weight`` (C, 1, 3, 3), and TNT's words conv
  ``patch_proj.kernel`` (7, 7, in, out) → (out, in, 7, 7);
- LayerNorm ``scale`` → ``weight``;
- every other leaf as it is: ``bias``, ``class_token``, ``pos_embedding``,
  PVT's ``cls_token`` and ``position_embedding{i}``, DeiT's ``cls_token``,
  ``dist_token`` and ``pos_embed``, the T2T performer's frozen ``w``, and the window
  attention's raw parameters, which keep flax's (in, out) layout in the
  port (``qkv_kernel``, ``proj_kernel``, ``qkv_bias``,
  ``relative_position_bias_table``; SwinV2's ``q_bias``, ``v_bias``,
  ``logit_scale``; Twins LSA's ``qkv_bias_p``, ``proj_bias_p``).

Reference, torchvision and facebook-DETR checkpoints load through
``utils/port_torch.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def vit_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return _walk(params, lambda prefix: prefix.startswith(
        ("pos_block", "pos_embedding.")))


def _walk(params: Mapping[str, Any], depthwise) -> Dict[str, torch.Tensor]:
    """The ViT family's walk; ``depthwise(prefix)`` says which ``kernel``
    leaves are depthwise convs."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], prefix: str) -> None:
        for key, sub in tree.items():
            if isinstance(sub, Mapping):
                walk(sub, f"{prefix}{key}.")
                continue
            if key == "kernel_q":
                # a QuantDense's int8 (in, out) kernel → QuantDense's
                # (out, in), still int8; its scale and bias fall through
                # to fp32 below
                arr = np.asarray(sub)
                if arr.dtype != np.int8:
                    raise ValueError(f"{prefix}kernel_q is {arr.dtype}, "
                                     "not int8")
                out[prefix + key] = torch.tensor(np.ascontiguousarray(arr.T))
                continue
            arr = np.asarray(sub, dtype=np.float32)
            if key == "kernel" and depthwise(prefix):
                key, arr = "weight", arr.transpose(3, 2, 0, 1)  # depthwise
            elif key == "kernel":
                key, arr = "weight", arr.reshape(-1, arr.shape[-1]).T
            elif key == "scale":
                key = "weight"
            # a contiguous copy: jax arrays are read-only
            out[prefix + key] = torch.tensor(np.ascontiguousarray(arr))

    walk(params, "")
    return out


def swin_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``SwinTransformer`` / ``SwinTransformerV2`` params → the port's
    ``state_dict`` (loads with ``strict=True``). The same walk as the ViT's:
    the tree's names are the port's module names."""
    return vit_state_dict_from_jax(params)


def pvt_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``PVT`` params → the port's ``state_dict`` (loads with
    ``strict=True``): the same walk again."""
    return vit_state_dict_from_jax(params)


def twins_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``TwinSVT`` params → the port's ``state_dict`` (loads with
    ``strict=True``); ``pos_block{k}.proj.kernel`` is the one depthwise conv
    kernel of the tree."""
    return vit_state_dict_from_jax(params)


def deit_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``DeiT`` params → the port's ``state_dict`` (loads with
    ``strict=True``): the ViT's walk (``block{i}``, ``norm_f``, ``head``,
    ``head_dist``, the two tokens and ``pos_embed`` by name)."""
    return vit_state_dict_from_jax(params)


def cpevit_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``CPEViT`` params → the port's ``state_dict`` (loads with
    ``strict=True``); ``pos_embedding.conv.kernel`` is the one depthwise
    conv kernel of the tree."""
    return vit_state_dict_from_jax(params)


def t2t_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``T2T_ViT`` params, either token type → the port's ``state_dict``
    (loads with ``strict=True``): ``t2t.attention{1,2}`` (the transformer's
    ``norm1``, ``attn.qkv``, ``attn.proj``, ``norm2``, ``mlp``; the
    performer's ``w``, ``kqv``, ``proj``, ``mlp_fc{1,2}``), ``t2t.project``
    and the ViT encoder, by the ViT's walk."""
    return vit_state_dict_from_jax(params)


def cpvt_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``CPVT`` / ``CPVTGAP`` params → the port's ``state_dict`` (loads with
    ``strict=True``): the ViT's walk, with ``pos_embedding.conv.kernel`` and
    every block's ``peg.conv.kernel`` the depthwise conv kernels."""
    return _walk(params, lambda prefix: prefix.startswith("pos_embedding.")
                 or prefix.endswith(".peg.conv."))


def tnt_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``TNT`` params → the port's ``state_dict`` (loads with
    ``strict=True``): DETR's walk, its one conv ``patch_proj`` real (7, 7,
    in, out) → (out, in, 7, 7), Dense kernels transposed, the SE layer's
    ``LayerNorm_0``, ``Dense_0`` and ``Dense_1`` by flax's names."""
    return detr_state_dict_from_jax(params)


def detr_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``Detr`` params (either backbone) → the port's ``state_dict`` (loads
    with ``strict=True``). Its own walk, because DETR's convolutions are
    real ones:

    - a conv ``kernel`` (kh, kw, in, out) → ``F.conv2d``'s ``weight``
      (out, in, kh, kw) (the ResNet, ``input_proj``; a depthwise (k, k, 1,
      C) kernel gives (C, 1, k, k));
    - a Dense ``kernel`` (in, out) → ``weight`` (out, in) (the ViT
      backbone's patch embedding is a Dense on patchified pixels);
    - ``scale`` → ``weight`` (LayerNorm, GroupNorm and ``FrozenBatchNorm``,
      whose ``bias``, ``mean`` and ``var`` keep their names);
    - everything else as it is: ``bias``, ``query_embed``, ``row_embed``,
      ``col_embed``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], prefix: str) -> None:
        for key, sub in tree.items():
            if isinstance(sub, Mapping):
                walk(sub, f"{prefix}{key}.")
                continue
            arr = np.asarray(sub, dtype=np.float32)
            if key == "kernel" and arr.ndim == 4:
                key, arr = "weight", arr.transpose(3, 2, 0, 1)
            elif key == "kernel":
                key, arr = "weight", arr.T
            elif key == "scale":
                key = "weight"
            out[prefix + key] = torch.tensor(np.ascontiguousarray(arr))

    walk(params, "")
    return out
