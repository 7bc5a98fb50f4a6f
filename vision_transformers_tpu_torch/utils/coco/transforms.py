"""Paired image+target transforms for detection (host-side numpy/PIL).

Counterpart of ``vision_transformers_tpu/utils/coco/transforms.py``, this
package's own copy (the port imports nothing of the JAX package).

Same capability surface as the reference's vendored DETR transforms
(utils/coco/transforms.py:16-276): functional crop/hflip/resize/pad that keep
boxes, masks and area consistent, and the transform classes RandomCrop,
RandomSizeCrop, CenterCrop, RandomHorizontalFlip, RandomResize, RandomPad,
RandomSelect, ToTensor, RandomErasing, Normalize, Compose. ``Normalize``
additionally converts boxes xyxy→cxcywh scaled to [0,1]
(transforms.py:242-258).

Representation: images are uint8 HWC numpy (float32 CHW after ToTensor, for
reference layout parity); targets are dicts of numpy arrays with absolute
xyxy ``boxes`` until Normalize. Randomness comes from an explicit
``np.random.RandomState`` (default a module RNG) so loaders are seedable.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

_GLOBAL_RNG = np.random.RandomState(0)


def _rng(rng):
    return rng if rng is not None else _GLOBAL_RNG


# ----------------------------------------------------------------- functional

def crop(image: np.ndarray, target: Dict, region: Tuple[int, int, int, int]):
    """region = (top, left, height, width)."""
    i, j, h, w = region
    image = image[i:i + h, j:j + w]
    target = dict(target)
    target["size"] = np.asarray([h, w])

    fields = [k for k in ("labels", "area", "iscrowd") if k in target]

    if "boxes" in target:
        boxes = target["boxes"].astype(np.float32)
        boxes = boxes - np.asarray([j, i, j, i], np.float32)
        boxes = np.minimum(boxes.reshape(-1, 2, 2), np.asarray([w, h], np.float32))
        boxes = np.clip(boxes, 0, None).reshape(-1, 4)
        target["area"] = (
            (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        )
        target["boxes"] = boxes
        fields.append("boxes")

    if "masks" in target:
        target["masks"] = target["masks"][:, i:i + h, j:j + w]
        fields.append("masks")

    # drop boxes/masks that became empty
    if "boxes" in target or "masks" in target:
        if "boxes" in target:
            b = target["boxes"].reshape(-1, 2, 2)
            keep = np.all(b[:, 1, :] > b[:, 0, :], axis=1)
        else:
            keep = target["masks"].reshape(len(target["masks"]), -1).any(axis=1)
        for f in set(fields):
            if f in target:
                target[f] = target[f][keep]
    return image, target


def hflip(image: np.ndarray, target: Dict):
    image = image[:, ::-1]
    h, w = image.shape[:2]
    target = dict(target)
    if "boxes" in target:
        boxes = target["boxes"].astype(np.float32)
        boxes = boxes[:, [2, 1, 0, 3]] * np.asarray([-1, 1, -1, 1], np.float32) \
            + np.asarray([w, 0, w, 0], np.float32)
        target["boxes"] = boxes
    if "masks" in target:
        target["masks"] = target["masks"][:, :, ::-1]
    return np.ascontiguousarray(image), target


def _get_size(image_size, size, max_size=None):
    """min-side resize target preserving aspect ratio (transforms semantics)."""
    h, w = image_size
    if isinstance(size, (list, tuple)):
        return tuple(size)
    if max_size is not None:
        min_orig, max_orig = min(h, w), max(h, w)
        if max_orig / min_orig * size > max_size:
            size = int(round(max_size * min_orig / max_orig))
    if (h <= w and h == size) or (w <= h and w == size):
        return h, w
    if h < w:
        return size, int(size * w / h)
    return int(size * h / w), size


def resize(image: np.ndarray, target: Optional[Dict], size, max_size=None):
    from PIL import Image

    oh, ow = _get_size(image.shape[:2], size, max_size)
    h, w = image.shape[:2]
    resized = np.asarray(
        Image.fromarray(image).resize((ow, oh), Image.BILINEAR))
    if target is None:
        return resized, None
    rw, rh = ow / w, oh / h
    target = dict(target)
    if "boxes" in target:
        target["boxes"] = target["boxes"].astype(np.float32) * np.asarray(
            [rw, rh, rw, rh], np.float32)
    if "area" in target:
        target["area"] = target["area"] * (rw * rh)
    target["size"] = np.asarray([oh, ow])
    if "masks" in target and len(target["masks"]):
        target["masks"] = np.stack([
            np.asarray(Image.fromarray(m.astype(np.uint8)).resize(
                (ow, oh), Image.NEAREST))
            for m in target["masks"]
        ]).astype(bool)
    return resized, target


def pad(image: np.ndarray, target: Optional[Dict], padding: Tuple[int, int]):
    """Pad bottom/right by (pad_w, pad_h) — reference pads bottom-right."""
    pw, ph = padding
    image = np.pad(image, ((0, ph), (0, pw), (0, 0)))
    if target is None:
        return image, None
    target = dict(target)
    target["size"] = np.asarray(image.shape[:2])
    if "masks" in target and len(target["masks"]):
        target["masks"] = np.pad(target["masks"], ((0, 0), (0, ph), (0, pw)))
    return image, target


# -------------------------------------------------------------------- classes

class RandomCrop:
    def __init__(self, size):
        self.size = size  # (h, w)

    def __call__(self, img, target, rng=None):
        rng = _rng(rng)
        h, w = img.shape[:2]
        th, tw = self.size
        i = rng.randint(0, max(h - th, 0) + 1)
        j = rng.randint(0, max(w - tw, 0) + 1)
        return crop(img, target, (i, j, min(th, h), min(tw, w)))


class RandomSizeCrop:
    def __init__(self, min_size: int, max_size: int):
        self.min_size = min_size
        self.max_size = max_size

    def __call__(self, img, target, rng=None):
        rng = _rng(rng)
        h, w = img.shape[:2]
        tw = rng.randint(self.min_size, min(w, self.max_size) + 1)
        th = rng.randint(self.min_size, min(h, self.max_size) + 1)
        i = rng.randint(0, h - th + 1)
        j = rng.randint(0, w - tw + 1)
        return crop(img, target, (i, j, th, tw))


class CenterCrop:
    def __init__(self, size):
        self.size = size

    def __call__(self, img, target, rng=None):
        h, w = img.shape[:2]
        th, tw = self.size
        return crop(img, target, ((h - th) // 2, (w - tw) // 2, th, tw))


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img, target, rng=None):
        if _rng(rng).rand() < self.p:
            return hflip(img, target)
        return img, target


class RandomResize:
    def __init__(self, sizes, max_size=None):
        self.sizes = list(sizes)
        self.max_size = max_size

    def __call__(self, img, target, rng=None):
        size = self.sizes[_rng(rng).randint(len(self.sizes))]
        return resize(img, target, size, self.max_size)


class RandomPad:
    def __init__(self, max_pad: int):
        self.max_pad = max_pad

    def __call__(self, img, target, rng=None):
        rng = _rng(rng)
        return pad(img, target,
                   (rng.randint(0, self.max_pad + 1),
                    rng.randint(0, self.max_pad + 1)))


class RandomSelect:
    """Apply transforms1 with probability p, else transforms2."""

    def __init__(self, transforms1, transforms2, p: float = 0.5):
        self.transforms1 = transforms1
        self.transforms2 = transforms2
        self.p = p

    def __call__(self, img, target, rng=None):
        if _rng(rng).rand() < self.p:
            return self.transforms1(img, target, rng)
        return self.transforms2(img, target, rng)


class ToTensor:
    """uint8 HWC → float32 CHW in [0,1] (reference layout parity)."""

    def __call__(self, img, target, rng=None):
        img = np.ascontiguousarray(
            img.astype(np.float32).transpose(2, 0, 1) / 255.0)
        return img, target


class RandomErasing:
    def __init__(self, p=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3)):
        self.p = p
        self.scale = scale
        self.ratio = ratio

    def __call__(self, img, target, rng=None):
        rng = _rng(rng)
        if rng.rand() >= self.p:
            return img, target
        chw = img.ndim == 3 and img.shape[0] in (1, 3)
        h, w = (img.shape[1:] if chw else img.shape[:2])
        area = h * w
        for _ in range(10):
            target_area = rng.uniform(*self.scale) * area
            ar = np.exp(rng.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            eh = int(round(np.sqrt(target_area / ar)))
            ew = int(round(np.sqrt(target_area * ar)))
            if eh < h and ew < w:
                i = rng.randint(0, h - eh)
                j = rng.randint(0, w - ew)
                img = img.copy()
                if chw:
                    img[:, i:i + eh, j:j + ew] = rng.randn(
                        img.shape[0], eh, ew).astype(img.dtype)
                else:
                    img[i:i + eh, j:j + ew] = 0
                break
        return img, target


class Normalize:
    """Normalize image; convert boxes xyxy→cxcywh in [0,1]
    (transforms.py:242-258)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img, target, rng=None):
        chw = img.ndim == 3 and img.shape[0] in (1, 3)
        if chw:
            img = (img - self.mean[:, None, None]) / self.std[:, None, None]
            h, w = img.shape[1:]
        else:
            img = (img.astype(np.float32) / 255.0 - self.mean) / self.std
            h, w = img.shape[:2]
        if target is None:
            return img, None
        target = dict(target)
        if "boxes" in target and len(target["boxes"]):
            b = target["boxes"].astype(np.float32)
            b = np.stack([
                (b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                b[:, 2] - b[:, 0], b[:, 3] - b[:, 1],
            ], axis=1)
            target["boxes"] = b / np.asarray([w, h, w, h], np.float32)
        return img, target


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, img, target, rng=None):
        for t in self.transforms:
            img, target = t(img, target, rng)
        return img, target

    def __repr__(self):
        return "Compose(" + ", ".join(map(repr, self.transforms)) + ")"
