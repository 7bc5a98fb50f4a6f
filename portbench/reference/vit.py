"""Plain fp32 ViT (arXiv:2010.11929): the reference of the ViT cells.

Pre-LN encoder: patch embedding as a product, a class token, learned
positions, L blocks of LN → multi-head self attention → residual and
LN → GELU MLP → residual, a final LN and a linear head on the class token.
Weights are named as the program's state dict names them (a data format
both sides read); the packed projection's columns are [q | k | v], heads
(head, dim) within each. LayerNorm eps 1e-6, as the program's ViT.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench.reference.common import (
    Quant,
    attention,
    gelu,
    layer_norm,
    linear,
    patchify,
)

EPS = 1e-6


def param_spec(m: dict) -> list:
    """(name, shape, std, mean) of every leaf, in the program's order."""
    d, f, c = m["hidden_dim"], m["mlp_dim"], m.get("in_channels", 3)
    p, L = m["patch_size"], m["num_layers"]
    s = (m["image_size"] // p) ** 2 + 1
    w = lambda o, i: ((o, i), i ** -0.5, 0.0)  # noqa: E731
    spec = [("conv_proj.proj.weight", *w(d, p * p * c)),
            ("conv_proj.proj.bias", (d,), 0.02, 0.0),
            ("class_token", (1, 1, d), 0.02, 0.0),
            ("encoder.pos_embedding", (1, s, d), 0.02, 0.0)]
    for i in range(L):
        b = f"encoder.encoder_layer_{i}."
        spec += [(b + "ln_1.weight", (d,), 0.1, 1.0),
                 (b + "ln_1.bias", (d,), 0.02, 0.0),
                 (b + "self_attention.qkv.weight", *w(3 * d, d)),
                 (b + "self_attention.qkv.bias", (3 * d,), 0.02, 0.0),
                 (b + "self_attention.out.weight", *w(d, d)),
                 (b + "self_attention.out.bias", (d,), 0.02, 0.0),
                 (b + "ln_2.weight", (d,), 0.1, 1.0),
                 (b + "ln_2.bias", (d,), 0.02, 0.0),
                 (b + "mlp.fc1.weight", *w(f, d)),
                 (b + "mlp.fc1.bias", (f,), 0.02, 0.0),
                 (b + "mlp.fc2.weight", *w(d, f)),
                 (b + "mlp.fc2.bias", (d,), 0.02, 0.0)]
    spec += [("encoder.ln.weight", (d,), 0.1, 1.0),
             ("encoder.ln.bias", (d,), 0.02, 0.0),
             ("head.weight", *w(m["num_classes"], d)),
             ("head.bias", (m["num_classes"],), 0.02, 0.0)]
    return spec


def seeds_per_forward(m: dict) -> int:
    """Block seeds a training forward draws (the cells run no dropout)."""
    if m.get("dropout", 0.0) or m.get("attention_dropout", 0.0):
        raise ValueError("the ViT reference runs at dropout 0")
    return 0


def forward(P: Dict[str, torch.Tensor], images: torch.Tensor, m: dict,
            quant: Quant = Quant.none,
            seeds: Optional[List[int]] = None) -> torch.Tensor:
    """(B, H, W, C) float32 images → (B, classes) logits."""
    d, h = m["hidden_dim"], m["num_heads"]
    dh = d // h
    x = linear(patchify(images, m["patch_size"]), P["conv_proj.proj.weight"],
               P["conv_proj.proj.bias"], quant)
    b, n = x.shape[0], x.shape[1] + 1
    x = torch.cat([P["class_token"].expand(b, 1, d), x], dim=1)
    x = x + P["encoder.pos_embedding"]
    for i in range(m["num_layers"]):
        pre = f"encoder.encoder_layer_{i}."
        y = layer_norm(x, P[pre + "ln_1.weight"], P[pre + "ln_1.bias"], EPS)
        qkv = linear(y, P[pre + "self_attention.qkv.weight"],
                     P[pre + "self_attention.qkv.bias"], quant)
        q, k, v = (t.reshape(b, n, h, dh).transpose(1, 2)
                   for t in qkv.split(d, dim=-1))
        o = attention(q, k, v, dh ** -0.5, None, quant)
        o = o.transpose(1, 2).reshape(b, n, d)
        x = x + linear(o, P[pre + "self_attention.out.weight"],
                       P[pre + "self_attention.out.bias"], quant)
        y = layer_norm(x, P[pre + "ln_2.weight"], P[pre + "ln_2.bias"], EPS)
        y = gelu(linear(y, P[pre + "mlp.fc1.weight"], P[pre + "mlp.fc1.bias"],
                        quant))
        x = x + linear(y, P[pre + "mlp.fc2.weight"], P[pre + "mlp.fc2.bias"],
                       quant)
    x = layer_norm(x, P["encoder.ln.weight"], P["encoder.ln.bias"], EPS)
    return linear(x[:, 0], P["head.weight"], P["head.bias"], quant)
