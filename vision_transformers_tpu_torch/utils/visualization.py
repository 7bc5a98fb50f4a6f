"""Visualization: patch grids and attention heatmaps.

Counterpart of ``vision_transformers_tpu/utils/visualization.py``:
``plot_patches`` and ``plot_attention_maps``, the reference's surface. Every
attention module of the port takes ``return_weights=True``, so the maps are
real. Images may be NHWC or NCHW, numpy arrays or torch tensors (on any
device). Figures are returned, and saved when asked, so headless hosts work
without a display. matplotlib and seaborn are imported inside the functions:
importing the package does not need them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def _np(x) -> np.ndarray:
    """numpy array, or a torch tensor on any device → numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if x.is_floating_point():
            x = x.float()
        x = x.numpy()
    return np.asarray(x)


def _to_numpy_img(img) -> np.ndarray:
    img = _np(img)
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
        img = img.transpose(1, 2, 0)
    if img.dtype != np.uint8:
        lo, hi = img.min(), img.max()
        img = (img - lo) / (hi - lo + 1e-9)
    return img


def plot_patches(images, patch_size: int, max_images: int = 4,
                 save_path: Optional[str] = None):
    """Grid of image patches next to the original, for the first
    ``max_images`` images."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    images = _np(images)[:max_images]
    n = len(images)
    fig, axes = plt.subplots(n, 2, figsize=(6, 3 * n), squeeze=False)
    for i, raw in enumerate(images):
        img = _to_numpy_img(raw)
        h, w = img.shape[:2]
        p = patch_size
        gh, gw = h // p, w // p
        patches = (
            img[: gh * p, : gw * p]
            .reshape(gh, p, gw, p, -1)
            .transpose(0, 2, 1, 3, 4)
        )
        grid = np.ones((gh * (p + 1), gw * (p + 1), patches.shape[-1]))
        for y in range(gh):
            for x in range(gw):
                grid[y * (p + 1):y * (p + 1) + p,
                     x * (p + 1):x * (p + 1) + p] = patches[y, x]
        axes[i][0].imshow(img)
        axes[i][0].set_title("original")
        axes[i][1].imshow(grid.squeeze())
        axes[i][1].set_title(f"patches {p}x{p}")
        for ax in axes[i]:
            ax.axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
    return fig


def plot_attention_maps(attention_weights: Sequence, layer: int = -1,
                        max_heads: int = 4, save_path: Optional[str] = None):
    """Per-head heatmaps of the first image for one layer.

    ``attention_weights``: list (per layer) of (B, H, S, S) arrays or
    tensors, as ``model(images, return_weights=True)`` returns them.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import seaborn as sns

    w = _np(attention_weights[layer])[0]  # first batch element
    heads = min(w.shape[0], max_heads)
    fig, axes = plt.subplots(1, heads, figsize=(4 * heads, 4), squeeze=False)
    for h in range(heads):
        sns.heatmap(w[h], ax=axes[0][h], cbar=h == heads - 1, square=True)
        axes[0][h].set_title(f"head {h}")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
    return fig
