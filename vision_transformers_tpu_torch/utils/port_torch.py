"""Port PyTorch reference checkpoints into this port's modules.

Counterpart of ``vision_transformers_tpu/utils/port_torch.py``. A user of the
reference trains with torch ``state_dict()`` checkpoints (torchvision-derived
module naming); these converters map them onto the ``state_dict`` of the
equivalent model here, so switching frameworks does not orphan existing
weights. Each returns the port's ``state_dict`` (the port's names, torch
layouts, fp32), which the model loads with ``strict=True``; the JAX package
returns flax trees with the same content, and
``utils.port_jax.*_state_dict_from_jax`` of those trees gives these same
tensors.

- ``port_vit_state_dict``: the reference ViT family (``conv_proj.*``,
  ``class_token``, ``encoder.layers.encoder_layer_{i}.*``, ``heads.head.*``),
  which covers torchvision ``vit_b_16``-style checkpoints too. The packed
  ``in_proj_weight`` is the port's ``qkv.weight`` as it is.
- ``port_swin_state_dict``: the reference Swin (torchvision ``features.{idx}``
  layout), and torchvision SwinV2 checkpoints with ``v2=True``.
- ``port_resnet50_state_dict``: torchvision ``resnet50`` (or the ResNet of a
  facebook-DETR checkpoint) → the DETR backbone's ``FrozenBatchNorm`` ResNet.
- ``port_detr_state_dict``: a facebook-DETR (detr-r50) checkpoint → ``Detr``.

Everything accepts torch tensors or numpy arrays. The conversions are
renames, splits and layout transforms; no numerics change.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(x: Any) -> torch.Tensor:
    """torch tensor or array-like → an owned, contiguous fp32 tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).contiguous().clone()
    return torch.tensor(np.ascontiguousarray(np.asarray(x, np.float32)))


def port_linear(weight: Any, bias: Any = None) -> StateDict:
    """torch ``nn.Linear`` → the port's ``Dense``: {weight (out, in), bias},
    the same layout."""
    out = {"weight": _t(weight)}
    if bias is not None:
        out["bias"] = _t(bias)
    return out


def port_layernorm(weight: Any, bias: Any) -> StateDict:
    """torch ``nn.LayerNorm`` → the port's ``LayerNorm`` {weight, bias}."""
    return {"weight": _t(weight), "bias": _t(bias)}


def port_conv_nchw(weight: Any) -> torch.Tensor:
    """torch Conv2d weight (O, I, kh, kw) → the port's ``F.conv2d`` weight,
    the same layout (the JAX function gives flax's HWIO)."""
    return _t(weight)


def port_patchify_conv(weight: Any) -> torch.Tensor:
    """torch stride-p p×p patch-embed conv (D, C, p, p) → the (D, p·p·C)
    weight of the matmul that ``ops.patch_embed.patchify`` feeds, whose
    features are ordered (ph, pw, c)."""
    w = _t(weight)
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1).contiguous()


def _get(sd: Mapping[str, Any], key: str) -> Any:
    if key not in sd:
        raise KeyError(
            f"checkpoint is missing '{key}' — not a reference-layout "
            f"state_dict? ({len(sd)} keys, e.g. {sorted(sd)[:3]})"
        )
    return sd[key]


def _prefixed(prefix: str, sd: Mapping[str, torch.Tensor]) -> StateDict:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def _strip_prefix(sd: Mapping[str, Any], prefixes=("backbone.0.body.",
                                                   "body.", "module.")):
    """Drop a common wrapper prefix (facebook-DETR nests the ResNet under
    ``backbone.0.body.``; DDP training saves under ``module.``)."""
    for pre in prefixes:
        if any(k.startswith(pre) for k in sd):
            return {k[len(pre):]: v for k, v in sd.items()
                    if k.startswith(pre)}
    return dict(sd)


def _port_frozen_bn(sd: Mapping[str, Any], p: str) -> StateDict:
    """torch BatchNorm2d's affine parameters and running statistics → the
    port's ``FrozenBatchNorm`` {weight, bias, mean, var}."""
    return {"weight": _t(_get(sd, f"{p}.weight")),
            "bias": _t(_get(sd, f"{p}.bias")),
            "mean": _t(_get(sd, f"{p}.running_mean")),
            "var": _t(_get(sd, f"{p}.running_var"))}


def port_resnet50_state_dict(state_dict: Mapping[str, Any],
                             stage_sizes=None) -> StateDict:
    """torchvision ``resnet50`` ``state_dict`` (or the ResNet nested in a
    facebook-DETR checkpoint under ``backbone.0.body.``) → the ``state_dict``
    of the DETR backbone's ``ResNet`` (``conv1``, ``bn1``,
    ``layer{s}_block{i}.{conv,bn}{1,2,3}``, ``down_conv``, ``down_bn``). The
    classifier ``fc.*`` keys are ignored; ``stage_sizes`` defaults to what
    the checkpoint's ``layer{s}.{i}.`` keys imply."""
    sd = _strip_prefix(state_dict)
    if stage_sizes is None:
        stage_sizes = tuple(
            1 + max(int(k.split(".")[1]) for k in sd
                    if k.startswith(f"layer{s}."))
            for s in (1, 2, 3, 4))
    out = {"conv1.weight": port_conv_nchw(_get(sd, "conv1.weight")),
           **_prefixed("bn1", _port_frozen_bn(sd, "bn1"))}
    for stage, blocks in enumerate(stage_sizes, start=1):
        for i in range(blocks):
            p, q = f"layer{stage}.{i}", f"layer{stage}_block{i}"
            for c in (1, 2, 3):
                out[f"{q}.conv{c}.weight"] = port_conv_nchw(
                    _get(sd, f"{p}.conv{c}.weight"))
                out.update(_prefixed(f"{q}.bn{c}",
                                     _port_frozen_bn(sd, f"{p}.bn{c}")))
            if f"{p}.downsample.0.weight" in sd:
                out[f"{q}.down_conv.weight"] = port_conv_nchw(
                    sd[f"{p}.downsample.0.weight"])
                out.update(_prefixed(f"{q}.down_bn", _port_frozen_bn(
                    sd, f"{p}.downsample.1")))
    return out


def _port_mha(sd: Mapping[str, Any], p: str) -> StateDict:
    """torch ``nn.MultiheadAttention`` (packed ``in_proj``) → the port's
    separate q/k/v/out projections (``object_detection/transformer.py``)."""
    w = _t(_get(sd, f"{p}.in_proj_weight"))
    b = _t(_get(sd, f"{p}.in_proj_bias"))
    d = w.shape[0] // 3
    out = {}
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        out[f"{name}.weight"] = w[i * d:(i + 1) * d].clone()
        out[f"{name}.bias"] = b[i * d:(i + 1) * d].clone()
    out.update(_prefixed("out_proj", port_linear(
        _get(sd, f"{p}.out_proj.weight"), _get(sd, f"{p}.out_proj.bias"))))
    return out


def _port_detr_layer(sd: Mapping[str, Any], p: str,
                     decoder: bool) -> StateDict:
    out = _prefixed("self_attn", _port_mha(sd, f"{p}.self_attn"))
    if decoder:
        out.update(_prefixed("multihead_attn",
                             _port_mha(sd, f"{p}.multihead_attn")))
    for name in ("linear1", "linear2"):
        out.update(_prefixed(name, port_linear(
            _get(sd, f"{p}.{name}.weight"), _get(sd, f"{p}.{name}.bias"))))
    for name in ("norm1", "norm2") + (("norm3",) if decoder else ()):
        out.update(_prefixed(name, port_layernorm(
            _get(sd, f"{p}.{name}.weight"), _get(sd, f"{p}.{name}.bias"))))
    return out


def _count_layers(sd: Mapping[str, Any], prefix: str) -> int:
    ids = [int(k[len(prefix):].split(".")[0])
           for k in sd if k.startswith(prefix)]
    if not ids:
        raise KeyError(
            f"checkpoint has no '{prefix}*' keys — not a DETR state_dict? "
            f"({len(sd)} keys, e.g. {sorted(sd)[:3]})")
    return 1 + max(ids)


def port_detr_state_dict(state_dict: Mapping[str, Any]) -> StateDict:
    """facebook-DETR ``state_dict`` (detr-r50 layout) → the ``state_dict`` of
    the port's ``Detr``: the ResNet-50 ``FrozenBatchNorm`` backbone under
    ``joiner.backbone``, the encoder and decoder with each packed MHA split
    into q/k/v, the class and box heads, the query embeddings and the 1×1
    input projection. The sine position encoding has no parameters. Layer
    counts come from the checkpoint; a checkpoint wrapped in ``model`` (the
    published ones) is unwrapped."""
    sd = dict(state_dict)
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]

    layers = {part: _count_layers(sd, f"transformer.{part}.layers.")
              for part in ("encoder", "decoder")}
    out = {}
    for part, n in layers.items():
        for i in range(n):
            out.update(_prefixed(f"transformer.{part}.layer{i}",
                                 _port_detr_layer(
                                     sd, f"transformer.{part}.layers.{i}",
                                     decoder=part == "decoder")))
    out.update(_prefixed("joiner.backbone", port_resnet50_state_dict(
        {k: v for k, v in sd.items() if k.startswith("backbone.")})))
    out["input_proj.weight"] = port_conv_nchw(_get(sd, "input_proj.weight"))
    out["input_proj.bias"] = _t(_get(sd, "input_proj.bias"))
    out.update(_prefixed("transformer.decoder.norm", port_layernorm(
        _get(sd, "transformer.decoder.norm.weight"),
        _get(sd, "transformer.decoder.norm.bias"))))
    out["query_embed"] = _t(_get(sd, "query_embed.weight"))
    out.update(_prefixed("class_embed", port_linear(
        _get(sd, "class_embed.weight"), _get(sd, "class_embed.bias"))))
    for i in range(3):
        out.update(_prefixed(f"bbox_embed.layer{i}", port_linear(
            _get(sd, f"bbox_embed.layers.{i}.weight"),
            _get(sd, f"bbox_embed.layers.{i}.bias"))))
    return out


def parse_model_key(name: str):
    """args-registry key → (family, is_swin_v2): the first ``_`` part,
    lower-cased, and whether it names a SwinV2 preset (the reference
    registers ``swin_*v2`` keys, utils/args.py:29-41). The one source of the
    routing that the CLI's ``_model_for`` and ``load_torch_checkpoint``
    share."""
    parts = name.lower().split("_")
    family = parts[0]
    v2 = family == "swin" and len(parts) > 1 and parts[1].endswith("v2")
    return family, v2


def load_torch_checkpoint(path: str, model_name: str,
                          model_args: Mapping[str, Any]) -> StateDict:
    """Load a reference torch checkpoint file and port it for the model the
    args-registry key names (``vit_*`` family, or ``swin_*`` with v2).

    Accepts a ``torch.save``d state_dict (or a dict with a ``state_dict`` /
    ``model`` entry, the common trainer wrappers) or a numpy ``.npz`` of the
    same keys."""
    if path.endswith(".npz"):
        with np.load(path) as npz:
            sd: Mapping[str, Any] = dict(npz)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        for wrapper in ("state_dict", "model"):
            if wrapper in sd and isinstance(sd[wrapper], dict):
                sd = sd[wrapper]
                break

    family, v2 = parse_model_key(model_name)
    if family == "swin":
        return port_swin_state_dict(sd, model_args["depths"], v2=v2)
    if family in ("vit", "vitb16", "vitl16", "vitti16"):
        return port_vit_state_dict(sd)
    raise ValueError(
        f"no torch porting rule for model family {family!r} — supported: "
        "vit*, swin* (see port_vit_state_dict / port_swin_state_dict)")


def port_vit_state_dict(state_dict: Mapping[str, Any],
                        num_layers: Optional[int] = None) -> StateDict:
    """Reference/torchvision ViT ``state_dict`` → the port's ``ViT``.

    Reference keys: ``conv_proj.{weight,bias}``, ``class_token``,
    ``encoder.pos_embedding``,
    ``encoder.layers.encoder_layer_{i}.{ln_1,ln_2}.{weight,bias}``,
    ``...self_attention.{in_proj_weight,in_proj_bias}`` (packed QKV, the
    port's ``qkv``), ``...self_attention.out_proj.{weight,bias}`` (``out``),
    ``...mlp.{0,3}.{weight,bias}`` (``fc1``, ``fc2``),
    ``encoder.ln.{weight,bias}`` and ``heads.head.{weight,bias}``.
    """
    sd = dict(state_dict)
    if num_layers is None:
        layer_ids = [
            int(k.split("encoder_layer_")[1].split(".")[0])
            for k in sd if "encoder_layer_" in k
        ]
        if not layer_ids:
            raise KeyError(
                "checkpoint has no 'encoder.layers.encoder_layer_*' keys — "
                f"not a reference-layout ViT state_dict? ({len(sd)} keys, "
                f"e.g. {sorted(sd)[:3]})"
            )
        num_layers = 1 + max(layer_ids)

    out = {"encoder.pos_embedding": _t(_get(sd, "encoder.pos_embedding")),
           "conv_proj.proj.weight": port_patchify_conv(
               _get(sd, "conv_proj.weight")),
           "conv_proj.proj.bias": _t(_get(sd, "conv_proj.bias")),
           "class_token": _t(_get(sd, "class_token"))}
    linears = (("self_attention.qkv", "self_attention.in_proj_"),
               ("self_attention.out", "self_attention.out_proj."),
               ("mlp.fc1", "mlp.0."), ("mlp.fc2", "mlp.3."))
    for i in range(num_layers):
        p = f"encoder.layers.encoder_layer_{i}"
        q = f"encoder.encoder_layer_{i}"
        for ln in ("ln_1", "ln_2"):
            out.update(_prefixed(f"{q}.{ln}", port_layernorm(
                _get(sd, f"{p}.{ln}.weight"), _get(sd, f"{p}.{ln}.bias"))))
        for name, src in linears:
            out.update(_prefixed(f"{q}.{name}", port_linear(
                _get(sd, f"{p}.{src}weight"), _get(sd, f"{p}.{src}bias"))))
    out.update(_prefixed("encoder.ln", port_layernorm(
        _get(sd, "encoder.ln.weight"), _get(sd, "encoder.ln.bias"))))
    out.update(_prefixed("head", port_linear(
        _get(sd, "heads.head.weight"), _get(sd, "heads.head.bias"))))
    return out


def _port_swin_attn(sd: Mapping[str, Any], p: str, v2: bool) -> StateDict:
    """The window attention's raw parameters keep flax's (in, out) layout in
    the port (``qkv_kernel``, ``proj_kernel``), so the Linear weights are
    transposed here."""
    out = {"qkv_kernel": _t(_get(sd, f"{p}.qkv.weight")).t().contiguous(),
           "proj_kernel": _t(_get(sd, f"{p}.proj.weight")).t().contiguous()}
    if f"{p}.proj.bias" in sd:
        out["proj_bias"] = _t(sd[f"{p}.proj.bias"])
    if v2:
        out["logit_scale"] = _t(_get(sd, f"{p}.logit_scale"))
        # torchvision V2 keeps one packed qkv.bias with the k third zeroed;
        # the port's module stores learned q/v biases and a constant-zero k
        # bias (ops/windows.py ShiftedWindowAttentionV2)
        if f"{p}.qkv.bias" in sd:
            b = _t(sd[f"{p}.qkv.bias"])
            d = b.shape[0] // 3
            out["q_bias"], out["v_bias"] = b[:d].clone(), b[2 * d:].clone()
        out.update(_prefixed("cpb_fc1", port_linear(
            _get(sd, f"{p}.cpb_mlp.0.weight"),
            _get(sd, f"{p}.cpb_mlp.0.bias"))))
        out["cpb_fc2.weight"] = _t(_get(sd, f"{p}.cpb_mlp.2.weight"))
    else:
        if f"{p}.qkv.bias" in sd:
            out["qkv_bias"] = _t(sd[f"{p}.qkv.bias"])
        out["relative_position_bias_table"] = _t(
            _get(sd, f"{p}.relative_position_bias_table"))
    return out


def port_swin_state_dict(state_dict: Mapping[str, Any],
                         depths: Sequence[int],
                         v2: bool = False) -> StateDict:
    """Reference/torchvision Swin ``state_dict`` → the port's
    ``SwinTransformer`` (``v2=True``: torchvision SwinV2 →
    ``SwinTransformerV2``).

    torchvision ``features`` layout: ``features.0`` = patch embedding (conv,
    Permute, LN); then per stage i, ``features.{2i+1}`` = the blocks and
    ``features.{2i+2}`` = PatchMerging (none after the last stage). The
    port's names: ``patch_embed``/``patch_norm``, ``stage{i}_block{j}.*``,
    ``merge{i}.*``, ``norm``, ``head``.
    """
    sd = dict(state_dict)
    out = {"patch_embed.weight": port_patchify_conv(
               _get(sd, "features.0.0.weight")),
           "patch_embed.bias": _t(_get(sd, "features.0.0.bias")),
           **_prefixed("patch_norm", port_layernorm(
               _get(sd, "features.0.2.weight"),
               _get(sd, "features.0.2.bias")))}
    for i_stage, depth in enumerate(depths):
        feat = 2 * i_stage + 1
        for j in range(depth):
            p, q = f"features.{feat}.{j}", f"stage{i_stage}_block{j}"
            for name in ("norm1", "norm2"):
                out.update(_prefixed(f"{q}.{name}", port_layernorm(
                    _get(sd, f"{p}.{name}.weight"),
                    _get(sd, f"{p}.{name}.bias"))))
            out.update(_prefixed(f"{q}.attn",
                                 _port_swin_attn(sd, f"{p}.attn", v2)))
            for name, src in (("fc1", "0"), ("fc2", "3")):
                out.update(_prefixed(f"{q}.mlp.{name}", port_linear(
                    _get(sd, f"{p}.mlp.{src}.weight"),
                    _get(sd, f"{p}.mlp.{src}.bias"))))
        if i_stage < len(depths) - 1:
            m, q = f"features.{2 * i_stage + 2}", f"merge{i_stage}"
            out.update(_prefixed(f"{q}.norm", port_layernorm(
                _get(sd, f"{m}.norm.weight"), _get(sd, f"{m}.norm.bias"))))
            w = _t(_get(sd, f"{m}.reduction.weight"))
            # torchvision's reduction has no bias; the port's carries one
            # (the reference keeps nn.Linear's default bias=True): zero is
            # the identity fill
            bias = sd.get(f"{m}.reduction.bias")
            out[f"{q}.reduction.weight"] = w
            out[f"{q}.reduction.bias"] = (torch.zeros(w.shape[0])
                                          if bias is None else _t(bias))
    out.update(_prefixed("norm", port_layernorm(
        _get(sd, "norm.weight"), _get(sd, "norm.bias"))))
    out.update(_prefixed("head", port_linear(
        _get(sd, "head.weight"), _get(sd, "head.bias"))))
    return out
