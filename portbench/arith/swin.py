"""Swin's work: the forward's multiply-accumulates per image and the
window attention calls of one forward, from the configuration's sizes.

``macs_per_image`` is the arithmetic of ``benchmarks/hier_bench.py::
swin_stage_macs`` (held there against XLA's cost analysis), copied so that
nothing of the benchmark imports that JAX file: the patch embedding, each
merge's 4C → 2C product, and per block qkv, the window scores and P·V, the
out projection and the MLP. The head is left out, as there.
"""

from __future__ import annotations


def macs_per_image(m: dict) -> int:
    p = m["patch_size"][0]
    t = (m["image_size"] // p) ** 2
    wh, ww = m["window_size"]
    n = wh * ww
    total = 0
    for i, depth in enumerate(m["depths"]):
        c = m["embed_dim"] * 2 ** i
        ti = t // 4 ** i
        if i == 0:
            total += t * (p * p * m.get("in_channels", 3)) * c
        else:
            total += ti * (4 * c // 2) * c
        per_block = (3 * ti * c * c + 2 * ti * n * c + ti * c * c
                     + int(2 * m["mlp_ratio"]) * ti * c * c)
        total += depth * per_block
    return total


def attention_calls(m: dict, batch: int) -> list:
    """One forward's window attention calls. A shifted block adds its
    per-window mask to the bias (nW' = nW bias planes, fp32), an unshifted
    one (or one whose window covers the map) shares one plane; the backward
    recomputes the probabilities from q, k, v and the bias, and writes the
    bias gradient."""
    wh, ww = m["window_size"]
    n = wh * ww
    side = m["image_size"] // m["patch_size"][0]
    calls = []
    for i, depth in enumerate(m["depths"]):
        s = side // 2 ** i
        h = m["num_heads"][i]
        nw = (s // wh) * (s // ww)
        dh = m["embed_dim"] * 2 ** i // h
        for j in range(depth):
            shifted = j % 2 == 1 and wh < s
            planes = nw if shifted else 1
            calls.append(dict(pairs=batch * nw * h, sq=n, sk=n, dh=dh,
                              bias_bytes=planes * h * n * n * 4,
                              dbias_bytes=h * n * n * 4, lse=False))
    return calls
