"""Plain fp32 Swin Transformer (arXiv:2103.14030): the reference of the
Swin cells.

Patch embedding as a product, then LN; four stages of blocks
x + SD(W-MSA(LN x)), x + SD(MLP(LN x)), every second block of a stage on a
map cyclically shifted by half a window, with the −100 mask between the
regions that the shift stitches together; a learned relative-position bias
per head; 2×2 patch merging (LN, then a linear map to 2C) between stages;
a final LN, the mean over positions and a linear head. LayerNorm eps 1e-5.
Weights are named as the program's state dict names them; the window
attention's two matrices are stored (in, out), the others (out, in).

One departure from the paper, which the program makes too and the
reference follows: the merging's linear map has a bias.

Stochastic depth is drawn from a host seed per block and forward
(``block_seeds`` in ``common``), with the rate rising linearly from 0 at
the first block to ``stochastic_depth_prob`` at the last; the attention
branch of a block takes seed + 4, the MLP branch seed + 5.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

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

EPS = 1e-5
MASK = -100.0


def _layout(m: dict):
    """[(name, stage, index in stage)] of blocks and merges, in order."""
    out = []
    for i, depth in enumerate(m["depths"]):
        out += [(f"stage{i}_block{j}", i, j) for j in range(depth)]
        if i < len(m["depths"]) - 1:
            out.append((f"merge{i}", i, None))
    return out


def param_spec(m: dict) -> List[Tuple[str, tuple, float, float]]:
    """(name, shape, std, mean) of every leaf."""
    c0, (ph, pw) = m["embed_dim"], m["patch_size"]
    cin = m.get("in_channels", 3)
    wh, ww = m["window_size"]
    table = (2 * wh - 1) * (2 * ww - 1)
    hid = lambda c: int(c * m["mlp_ratio"])  # noqa: E731
    w = lambda o, i: ((o, i), i ** -0.5, 0.0)  # noqa: E731  (out, in)
    ln = lambda n, c: [(n + ".weight", (c,), 0.1, 1.0),  # noqa: E731
                       (n + ".bias", (c,), 0.02, 0.0)]
    spec = [("patch_embed.weight", *w(c0, ph * pw * cin)),
            ("patch_embed.bias", (c0,), 0.02, 0.0)] + ln("patch_norm", c0)
    for name, i, j in _layout(m):
        c = c0 * 2 ** i
        if j is None:
            spec += ln(name + ".norm", 4 * c)
            spec += [(name + ".reduction.weight", *w(2 * c, 4 * c)),
                     (name + ".reduction.bias", (2 * c,), 0.02, 0.0)]
            continue
        a = name + ".attn."
        spec += ln(name + ".norm1", c)
        spec += [(a + "qkv_kernel", (c, 3 * c), c ** -0.5, 0.0),
                 (a + "proj_kernel", (c, c), c ** -0.5, 0.0),
                 (a + "proj_bias", (c,), 0.02, 0.0),
                 (a + "relative_position_bias_table",
                  (table, m["num_heads"][i]), 1.0, 0.0),
                 (a + "qkv_bias", (3 * c,), 0.02, 0.0)]
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


def seeds_per_forward(m: dict) -> int:
    """Block seeds a training forward draws: one per block and merge."""
    return len(_layout(m))


def relative_index(wh: int, ww: int) -> torch.Tensor:
    """(N·N,) index of each (query, key) offset into the bias table."""
    ys, xs = np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    dy = ys[:, None] - ys[None, :] + wh - 1
    dx = xs[:, None] - xs[None, :] + ww - 1
    return torch.from_numpy((dy * (2 * ww - 1) + dx).reshape(-1))


def shift_mask(hp: int, wp: int, wh: int, ww: int, sh: int,
               sw: int) -> torch.Tensor:
    """(nW, N, N): −100 between positions of a window that come from
    different regions of the shifted map, 0 elsewhere."""
    label = np.zeros((hp, wp), np.int64)
    rows = ((0, hp - wh), (hp - wh, hp - sh), (hp - sh, hp))
    cols = ((0, wp - ww), (wp - ww, wp - sw), (wp - sw, wp))
    for r, (r0, r1) in enumerate(rows):
        for q, (c0, c1) in enumerate(cols):
            label[r0:r1, c0:c1] = 3 * r + q
    win = label.reshape(hp // wh, wh, wp // ww, ww).transpose(0, 2, 1, 3)
    win = win.reshape(-1, wh * ww)
    same = win[:, :, None] == win[:, None, :]
    return torch.from_numpy(np.where(same, 0.0, MASK).astype(np.float32))


def _windows(x: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // wh, wh, w // ww, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, wh * ww, c)


def _unwindows(x: torch.Tensor, wh: int, ww: int, h: int,
               w: int) -> torch.Tensor:
    c = x.shape[-1]
    b = x.shape[0] // ((h // wh) * (w // ww))
    x = x.reshape(b, h // wh, w // ww, wh, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def window_attention(x, P, pre, heads, window, shift, quant):
    """W-MSA / SW-MSA on a (B, H, W, C) map whose sides are window
    multiples."""
    b, h, w, c = x.shape
    wh, ww = window
    sh, sw = shift
    dh = c // heads
    n = wh * ww
    if sh or sw:
        x = torch.roll(x, shifts=(-sh, -sw), dims=(1, 2))
    qkv = matmul(x, P[pre + "qkv_kernel"], quant) + P[pre + "qkv_bias"]
    qkv = _windows(qkv, wh, ww)                       # (G, N, 3C)
    g = qkv.shape[0]
    q, k, v = qkv.reshape(g, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    table = P[pre + "relative_position_bias_table"]
    bias = table[relative_index(wh, ww).to(x.device)].reshape(
        n, n, heads).permute(2, 0, 1)                  # (H, N, N)
    nw = (h // wh) * (w // ww)
    bias = bias[None].expand(nw, heads, n, n)
    if sh or sw:
        bias = bias + shift_mask(h, w, wh, ww, sh, sw).to(x.device)[:, None]
    bias = bias.repeat(b, 1, 1, 1)                     # window g: g mod nW
    o = attention(q, k, v, dh ** -0.5, bias, quant)    # (G, H, N, dh)
    o = _unwindows(o.transpose(1, 2).reshape(g, n, c), wh, ww, h, w)
    if sh or sw:
        o = torch.roll(o, shifts=(sh, sw), dims=(1, 2))
    return matmul(o, P[pre + "proj_kernel"], quant) + P[pre + "proj_bias"]


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
    window = tuple(m["window_size"])
    total = sum(m["depths"])
    block_id = 0
    for slot, (name, i, j) in enumerate(_layout(m)):
        if j is None:
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                           x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
            x = layer_norm(x, P[name + ".norm.weight"],
                           P[name + ".norm.bias"], EPS)
            x = linear(x, P[name + ".reduction.weight"],
                       P[name + ".reduction.bias"], quant)
            continue
        rate = m["stochastic_depth_prob"] * block_id / max(total - 1, 1)
        block_id += 1
        shift = tuple(0 if (j % 2 == 0 or win >= side) else win // 2
                      for win, side in zip(window, x.shape[1:3]))
        y = layer_norm(x, P[name + ".norm1.weight"], P[name + ".norm1.bias"],
                       EPS)
        y = window_attention(y, P, name + ".attn.", m["num_heads"][i],
                             window, shift, quant)
        if seeds is not None:
            y = drop_path(y, rate, seeds[slot] + 4)
        x = x + y
        y = layer_norm(x, P[name + ".norm2.weight"], P[name + ".norm2.bias"],
                       EPS)
        y = gelu(linear(y, P[name + ".mlp.fc1.weight"],
                        P[name + ".mlp.fc1.bias"], quant))
        y = linear(y, P[name + ".mlp.fc2.weight"], P[name + ".mlp.fc2.bias"],
                   quant)
        if seeds is not None:
            y = drop_path(y, rate, seeds[slot] + 5)
        x = x + y
    x = layer_norm(x, P["norm.weight"], P["norm.bias"], EPS)
    return linear(x.mean(dim=(1, 2)), P["head.weight"], P["head.bias"], quant)
