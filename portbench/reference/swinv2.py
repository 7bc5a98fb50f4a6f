"""Plain fp32 Swin Transformer V2 (arXiv:2111.09883): the reference of the
SwinV2 cells.

Patch embedding as a product, then LN; four stages of post-norm blocks
x + SD(LN(W-MSA(x))), x + SD(LN(MLP(x))), every second block of a stage on
a map cyclically shifted by half a window, with the −100 mask between the
regions that the shift stitches together; 2×2 patch merging (a linear map
4C → 2C, then LN) between stages; a final LN, the mean over positions and
a linear head. LayerNorm eps 1e-5.

The attention is the paper's scaled cosine attention (§3.2):
cos(q, k) · exp(min(logit_scale, log 100)) + B, per head, with q and k
L2-normalised along the head dim, the k projection without a bias (q and v
have one), and B the continuous position bias: a 2 → 512 → heads MLP (ReLU,
no bias on its second layer) over the log-spaced relative coordinates
sign(Δ)·log2(1 + 8·|Δ|/(window − 1)) / log2 8, squashed to (0, 16) by
16·sigmoid as the published code does. Each stage's window is
min(window, map side), and a shifted block shifts only where the window
does not cover the map, as the published code and timm do. Weights are
named as the program's state dict names them; the window attention's two
matrices are stored (in, out), the others (out, in).

Departures from the paper, which the program makes too and the reference
follows: the merging's linear map has a bias; the CPB table is computed
from the window of each stage as it is attended (no pretrained window).

Every block is recomputed in the backward (``torch.utils.checkpoint``,
non-reentrant): same equations and the same stochastic-depth masks (each
drawn from its own seeded generator, so the recompute draws them again),
and only the block inputs are kept, so that the whole-batch reference fits
on the card beside what the program left.

Stochastic depth is drawn from a host seed per block and forward
(``block_seeds`` in ``common``), with the rate rising linearly from 0 at
the first block to ``stochastic_depth_prob`` at the last; the attention
branch of a block takes seed + 4, the MLP branch seed + 5.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference.common import (
    Quant,
    attention,
    drop_path,
    gelu,
    layer_norm,
    linear,
    matmul,
    patchify,
)
from portbench.reference.swin import (  # noqa: F401  (seeds_per_forward)
    _layout,
    _unwindows,
    _windows,
    relative_index,
    seeds_per_forward,
    shift_mask,
)

EPS = 1e-5
CPB_HIDDEN = 512
BIAS_RANGE = 16.0
MAX_LOGIT_SCALE = math.log(100.0)


def stage_windows(m: dict) -> List[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """Each stage's (window, shift of its shifted blocks): the window is
    min(window, map side) and the shift half of it where it does not cover
    the map, else 0."""
    side = m["image_size"] // m["patch_size"][0]
    out = []
    for _ in m["depths"]:
        window = tuple(min(w, side) for w in m["window_size"])
        out.append((window, tuple(0 if side <= w else w // 2
                                  for w in window)))
        side = (side + 1) // 2
    return out


def param_spec(m: dict) -> List[Tuple[str, tuple, float, float]]:
    """(name, shape, std, mean) of every leaf."""
    c0, (ph, pw) = m["embed_dim"], m["patch_size"]
    cin = m.get("in_channels", 3)
    hid = lambda c: int(c * m["mlp_ratio"])  # noqa: E731
    w = lambda o, i: ((o, i), i ** -0.5, 0.0)  # noqa: E731  (out, in)
    ln = lambda n, c: [(n + ".weight", (c,), 0.1, 1.0),  # noqa: E731
                       (n + ".bias", (c,), 0.02, 0.0)]
    spec = [("patch_embed.weight", *w(c0, ph * pw * cin)),
            ("patch_embed.bias", (c0,), 0.02, 0.0)] + ln("patch_norm", c0)
    for name, i, j in _layout(m):
        c = c0 * 2 ** i
        if j is None:
            spec += [(name + ".reduction.weight", *w(2 * c, 4 * c)),
                     (name + ".reduction.bias", (2 * c,), 0.02, 0.0)]
            spec += ln(name + ".norm", 2 * c)
            continue
        a = name + ".attn."
        h = m["num_heads"][i]
        spec += ln(name + ".norm1", c)
        spec += [(a + "qkv_kernel", (c, 3 * c), c ** -0.5, 0.0),
                 (a + "proj_kernel", (c, c), c ** -0.5, 0.0),
                 (a + "proj_bias", (c,), 0.02, 0.0),
                 (a + "logit_scale", (h, 1, 1), 0.1, math.log(10.0)),
                 (a + "q_bias", (c,), 0.02, 0.0),
                 (a + "v_bias", (c,), 0.02, 0.0),
                 (a + "cpb_fc1.weight", *w(CPB_HIDDEN, 2)),
                 (a + "cpb_fc1.bias", (CPB_HIDDEN,), 0.02, 0.0),
                 (a + "cpb_fc2.weight", *w(h, CPB_HIDDEN))]
        spec += ln(name + ".norm2", c)
        spec += [(name + ".mlp.fc1.weight", *w(hid(c), c)),
                 (name + ".mlp.fc1.bias", (hid(c),), 0.02, 0.0),
                 (name + ".mlp.fc2.weight", *w(c, hid(c))),
                 (name + ".mlp.fc2.bias", (c,), 0.02, 0.0)]
    cf = c0 * 2 ** (len(m["depths"]) - 1)
    spec += ln("norm", cf)
    spec += [("head.weight", *w(m["num_classes"], cf)),
             ("head.bias", (m["num_classes"],), 0.02, 0.0)]
    return spec


def coords_table(wh: int, ww: int) -> torch.Tensor:
    """((2wh−1)(2ww−1), 2) log-spaced relative coordinates, rows in the
    order of ``relative_index``'s table."""
    dy, dx = np.meshgrid(np.arange(-(wh - 1), wh, dtype=np.float64),
                         np.arange(-(ww - 1), ww, dtype=np.float64),
                         indexing="ij")
    t = np.stack([dy / max(wh - 1, 1), dx / max(ww - 1, 1)], -1) * 8.0
    t = np.sign(t) * np.log2(np.abs(t) + 1.0) / np.log2(8.0)
    return torch.from_numpy(t.reshape(-1, 2).astype(np.float32))


def position_bias(P, pre, heads, wh, ww, quant, device) -> torch.Tensor:
    """(heads, N, N) continuous position bias, 16·sigmoid(MLP(coords))."""
    n = wh * ww
    hidden = torch.relu(linear(coords_table(wh, ww).to(device),
                               P[pre + "cpb_fc1.weight"],
                               P[pre + "cpb_fc1.bias"], quant))
    table = linear(hidden, P[pre + "cpb_fc2.weight"], None, quant)
    bias = table[relative_index(wh, ww).to(device)].reshape(n, n, heads)
    return BIAS_RANGE * torch.sigmoid(bias.permute(2, 0, 1))


def window_attention(x, P, pre, heads, window, shift, quant):
    """Shifted-window cosine attention on a (B, H, W, C) map whose sides are
    window multiples."""
    b, h, w, c = x.shape
    wh, ww = window
    sh, sw = shift
    dh = c // heads
    n = wh * ww
    if h % wh or w % ww:
        raise ValueError(f"map {h}x{w} is no multiple of window {window}")
    if sh or sw:
        x = torch.roll(x, shifts=(-sh, -sw), dims=(1, 2))
    qkv_bias = torch.cat([P[pre + "q_bias"],
                          torch.zeros_like(P[pre + "q_bias"]),
                          P[pre + "v_bias"]])
    qkv = matmul(x, P[pre + "qkv_kernel"], quant) + qkv_bias
    qkv = _windows(qkv, wh, ww)                       # (G, N, 3C)
    g = qkv.shape[0]
    q, k, v = qkv.reshape(g, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    q = torch.nn.functional.normalize(q, dim=-1)
    k = torch.nn.functional.normalize(k, dim=-1)
    temperature = torch.exp(torch.clamp(P[pre + "logit_scale"],
                                        max=MAX_LOGIT_SCALE))   # (H, 1, 1)
    bias = position_bias(P, pre, heads, wh, ww, quant, x.device)
    nw = (h // wh) * (w // ww)
    bias = bias[None].expand(nw, heads, n, n)
    if sh or sw:
        bias = bias + shift_mask(h, w, wh, ww, sh, sw).to(x.device)[:, None]
    bias = bias.repeat(b, 1, 1, 1)                     # window g: g mod nW
    o = attention(q, k, v, temperature, bias, quant)   # (G, H, N, dh)
    o = _unwindows(o.transpose(1, 2).reshape(g, n, c), wh, ww, h, w)
    if sh or sw:
        o = torch.roll(o, shifts=(sh, sw), dims=(1, 2))
    return matmul(o, P[pre + "proj_kernel"], quant) + P[pre + "proj_bias"]


def _block(x, P, name, heads, window, shift, rate, seed, quant):
    """One post-norm block; ``seed`` None outside training."""
    y = window_attention(x, P, name + ".attn.", heads, window, shift, quant)
    y = layer_norm(y, P[name + ".norm1.weight"], P[name + ".norm1.bias"], EPS)
    if seed is not None:
        y = drop_path(y, rate, seed + 4)
    x = x + y
    y = gelu(linear(x, P[name + ".mlp.fc1.weight"], P[name + ".mlp.fc1.bias"],
                    quant))
    y = linear(y, P[name + ".mlp.fc2.weight"], P[name + ".mlp.fc2.bias"],
               quant)
    y = layer_norm(y, P[name + ".norm2.weight"], P[name + ".norm2.bias"], EPS)
    if seed is not None:
        y = drop_path(y, rate, seed + 5)
    return x + y


def forward(P: Dict[str, torch.Tensor], images: torch.Tensor, m: dict,
            quant: Quant = Quant.none,
            seeds: Optional[List[int]] = None) -> torch.Tensor:
    """(B, H, W, C) float32 images → (B, classes) logits. ``seeds``: this
    forward's block seeds in training (stochastic depth), else None."""
    ph, pw = m["patch_size"]
    b, hi, wi, _ = images.shape
    x = linear(patchify(images, ph), P["patch_embed.weight"],
               P["patch_embed.bias"], quant)
    x = layer_norm(x, P["patch_norm.weight"], P["patch_norm.bias"], EPS)
    x = x.reshape(b, hi // ph, wi // pw, -1)
    windows = stage_windows(m)
    total = sum(m["depths"])
    block_id = 0
    for slot, (name, i, j) in enumerate(_layout(m)):
        if j is None:
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                           x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
            x = linear(x, P[name + ".reduction.weight"],
                       P[name + ".reduction.bias"], quant)
            x = layer_norm(x, P[name + ".norm.weight"],
                           P[name + ".norm.bias"], EPS)
            continue
        rate = m["stochastic_depth_prob"] * block_id / max(total - 1, 1)
        block_id += 1
        window, half = windows[i]
        shift = half if j % 2 else (0, 0)
        seed = None if seeds is None else seeds[slot]
        args = (P, name, m["num_heads"][i], window, shift, rate, seed, quant)
        if torch.is_grad_enabled():
            x = checkpoint(_block, x, *args, use_reentrant=False)
        else:
            x = _block(x, *args)
    x = layer_norm(x, P["norm.weight"], P["norm.bias"], EPS)
    return linear(x.mean(dim=(1, 2)), P["head.weight"], P["head.bias"], quant)
