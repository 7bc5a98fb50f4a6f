"""ViT's work: the forward's multiply-accumulates per image and the
attention calls of one forward, from the configuration's sizes alone.

``macs_per_image`` is the arithmetic of ``benchmarks/hier_bench.py::
vit_stage_macs`` (held there against XLA's cost analysis), copied so that
nothing of the benchmark imports that JAX file: the patch embedding over
every token, then per block the four d×d products, the scores and P·V, and
the MLP's two products. The head is left out, as there.
"""

from __future__ import annotations


def macs_per_image(m: dict) -> int:
    p, d = m["patch_size"], m["hidden_dim"]
    t = (m["image_size"] // p) ** 2 + 1
    per_block = 4 * t * d * d + 2 * t * t * d + 2 * t * d * m["mlp_dim"]
    return t * (p * p * m.get("in_channels", 3)) * d \
        + m["num_layers"] * per_block


def attention_calls(m: dict, batch: int) -> list:
    """One forward's attention calls: every layer attends over all tokens
    of each image and head; the forward keeps an lse for the backward."""
    t = (m["image_size"] // m["patch_size"]) ** 2 + 1
    h = m["num_heads"]
    call = dict(pairs=batch * h, sq=t, sk=t, dh=m["hidden_dim"] // h,
                bias_bytes=0, dbias_bytes=0, lse=True)
    return [call] * m["num_layers"]
