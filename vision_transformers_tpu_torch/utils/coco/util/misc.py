"""Detection misc: padded batching (NestedTensor), resize, loss-dict reduce.

Counterpart of ``vision_transformers_tpu/utils/coco/util/misc.py``, the
part the detection path needs:

- ``NestedTensor``: (B, H, W, C) padded batch + (B, H, W) bool mask, True on
  padding (NHWC, as in the JAX package). Collation makes numpy arrays on the
  host; ``to(device)`` moves both to torch tensors on a device.
- ``nested_tensor_from_tensor_list`` / ``collate_fn`` with **shape
  bucketing**: padded sizes are rounded up to a 128 grid (capped at 1344),
  so COCO's scales map to a handful of shapes.
- ``interpolate``: ``F.interpolate`` with ``jax.image.resize``'s arithmetic.
- ``reduce_dict``: a dict of scalars summed (or averaged) over the ranks.
- The JAX module's re-exports of ``parallel.distributed``
  (``init_distributed_mode``, ``all_gather`` = ``all_gather_objects``,
  ``get_rank``, ``get_world_size``, ``is_main_process``, ``save_on_master``)
  and of ``utils.metrics`` (``MetricLogger``, ``SmoothedValue``,
  ``accuracy`` = ``accuracy_topk``, ``get_sha``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from vision_transformers_tpu_torch.parallel.distributed import all_reduce_host
# the JAX module's re-exports
from vision_transformers_tpu_torch.parallel.distributed import (  # noqa: F401
    all_gather_objects as all_gather,
    get_rank,
    get_world_size,
    init_distributed_mode,
    is_main_process,
    save_on_master,
)
from vision_transformers_tpu_torch.utils.metrics import (  # noqa: F401
    MetricLogger,
    SmoothedValue,
    accuracy_topk as accuracy,
    get_sha,
)


def reduce_dict(input_dict: dict, average: bool = True) -> dict:
    """A dict of scalars summed over the ranks, or averaged with
    ``average``, in float64 (the reference's ``reduce_dict``); unchanged in
    one process."""
    world = get_world_size()
    if world == 1:
        return dict(input_dict)
    keys = sorted(input_dict)
    summed = all_reduce_host([float(input_dict[k]) for k in keys])
    if average:
        summed = summed / world
    return {k: float(v) for k, v in zip(keys, summed)}


def interpolate(array: torch.Tensor, size=None, scale_factor=None,
                mode: str = "nearest") -> torch.Tensor:
    """Resize (N, H, W, C) or (N, C, H, W) tensors as ``jax.image.resize``
    does: "nearest" is F.interpolate's ``nearest-exact`` (pixel centres;
    torch's ``nearest`` floors and picks other pixels), "bilinear" is
    half-pixel bilinear with antialiasing when it shrinks. The layout test
    is the JAX function's."""
    nchw = (array.shape[1] <= 4 < array.shape[-1]
            or array.shape[1] < array.shape[-1] // 8)
    if size is None:
        h, w = array.shape[2:] if nchw else array.shape[1:3]
        size = (int(h * scale_factor), int(w * scale_factor))
    x = array if nchw else array.permute(0, 3, 1, 2)
    if mode == "nearest":
        y = F.interpolate(x, size=tuple(size), mode="nearest-exact")
    elif mode == "bilinear":
        y = F.interpolate(x, size=tuple(size), mode="bilinear",
                          align_corners=False, antialias=True)
    else:
        raise ValueError(f"mode {mode!r}: 'nearest' or 'bilinear'")
    return y if nchw else y.permute(0, 2, 3, 1)


# ------------------------------------------------------------- NestedTensor

SIZE_BUCKET = 128  # pad H/W up to multiples of this → few static shapes


def bucket_size(x: int, bucket: int = SIZE_BUCKET, max_size: int = 1344) -> int:
    return min(-(-x // bucket) * bucket, max_size)


Array = Union[np.ndarray, torch.Tensor]


@dataclass
class NestedTensor:
    """Padded image batch (NHWC) + padding mask (True = padded)."""

    tensors: Array  # (B, H, W, C) float32
    mask: Array     # (B, H, W) bool

    def decompose(self):
        return self.tensors, self.mask

    @property
    def shape(self):
        return self.tensors.shape

    def to(self, device) -> "NestedTensor":
        """Both arrays as torch tensors on ``device``."""
        return NestedTensor(torch.as_tensor(self.tensors, device=device),
                            torch.as_tensor(self.mask, device=device))


def _as_hwc(img: np.ndarray) -> np.ndarray:
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
        return np.ascontiguousarray(img.transpose(1, 2, 0))
    return img


def nested_tensor_from_tensor_list(
    images: Sequence[np.ndarray],
    size_bucket: int = SIZE_BUCKET,
) -> NestedTensor:
    """Pad a list of HWC/CHW float images to the bucketed batch max
    (numpy, on the host)."""
    images = [_as_hwc(np.asarray(im)) for im in images]
    max_h = max(im.shape[0] for im in images)
    max_w = max(im.shape[1] for im in images)
    H = bucket_size(max_h, size_bucket)
    W = bucket_size(max_w, size_bucket)
    c = images[0].shape[2]
    b = len(images)

    out = np.zeros((b, H, W, c), np.float32)
    mask = np.ones((b, H, W), bool)
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        out[i, :h, :w] = im
        mask[i, :h, :w] = False
    return NestedTensor(out, mask)


def collate_fn(batch) -> Tuple[NestedTensor, tuple]:
    """DETR collate: batch list of (image, target) → (NestedTensor,
    targets)."""
    images, targets = list(zip(*batch))
    return nested_tensor_from_tensor_list(images), targets
