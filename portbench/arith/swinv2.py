"""SwinV2's work: the forward's multiply-accumulates per image and the
window attention calls of one forward, from the configuration's sizes,
with each stage's window as the published rule clips it (``reference.
swinv2.stage_windows``).

The products are Swin's (``arith/swin.py``): the patch embedding, each
merge's 4C → 2C product, and per block qkv, the window scores and P·V at
the stage's own N, the out projection and the MLP; the head is left out.
The continuous position bias's MLP runs once a block and forward, not per
image (about 3 M multiply-adds a block at window 16), and is left out too,
as are the cosine normalisation and the other elementwise passes.
"""

from __future__ import annotations

from portbench.arith.swin import attention_calls as _swin_calls
from portbench.reference.swinv2 import stage_windows

# above this many tokens a window takes the split-head attention (the
# window kernels' contract, ops/flash_attention.py MAX_WINDOW_TOKENS)
MAX_WINDOW_TOKENS = 128


def macs_per_image(m: dict) -> int:
    p = m["patch_size"][0]
    t = (m["image_size"] // p) ** 2
    total = 0
    for i, (depth, ((wh, ww), _)) in enumerate(zip(m["depths"],
                                                   stage_windows(m))):
        c = m["embed_dim"] * 2 ** i
        ti = t // 4 ** i
        n = wh * ww
        if i == 0:
            total += t * (p * p * m.get("in_channels", 3)) * c
        else:
            total += ti * (4 * c // 2) * c
        per_block = (3 * ti * c * c + 2 * ti * n * c + ti * c * c
                     + int(2 * m["mlp_ratio"]) * ti * c * c)
        total += depth * per_block
    return total


def attention_calls(m: dict, batch: int) -> list:
    """One forward's window attention calls, stage by stage at the stage's
    window. A window of more than 128 tokens takes the split-head
    attention: the forward keeps an lse, the bias goes in as nW' fp32
    planes (nW' = nW in a shifted block, else 1), and the backward writes
    the gradient of the shared bias. A smaller one is a window kernel's
    call as in Swin (``arith.swin.attention_calls``)."""
    side = m["image_size"] // m["patch_size"][0]
    calls = []
    for i, (depth, ((wh, ww), shift)) in enumerate(zip(m["depths"],
                                                       stage_windows(m))):
        s = side // 2 ** i
        h = m["num_heads"][i]
        n = wh * ww
        nw = (s // wh) * (s // ww)
        dh = m["embed_dim"] * 2 ** i // h
        if n <= MAX_WINDOW_TOKENS:
            one = dict(m, image_size=s * m["patch_size"][0], depths=[depth],
                       num_heads=[h], window_size=[wh, ww],
                       embed_dim=m["embed_dim"] * 2 ** i)
            calls += _swin_calls(one, batch)
            continue
        for j in range(depth):
            planes = nw if j % 2 == 1 and any(shift) else 1
            calls.append(dict(pairs=batch * nw * h, sq=n, sk=n, dh=dh,
                              bias_bytes=planes * h * n * n * 4,
                              dbias_bytes=h * n * n * 4, lse=True))
    return calls
