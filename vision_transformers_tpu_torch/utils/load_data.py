"""Host data pipeline: prefetching loaders feeding uint8 batches.

Counterpart of ``vision_transformers_tpu/utils/load_data.py``, with the
reference's public surface (utils/load_data.py:11-44):
``get_train_test_loaders(dataset_name, batch_size, num_workers, val_split,
root_dir)`` returning 2 or 3 loaders.

- Batches are augmented uint8 NHWC numpy arrays; the normalization constants
  ride on ``loader.normalize`` and the train step applies them on the
  device.
- Augmentation (random crop pad 4 + hflip + brightness jitter for CIFAR;
  RandomResizedCrop / Resize + CenterCrop for image folders) runs vectorized
  over whole batches, by the fused C++ loop (``native``) where it builds and
  the seed-compatible numpy three-pass path otherwise, in a prefetch thread.
- CIFAR is read from the standard python pickle batches (no torchvision, no
  download; a clear error names the expected path).

Unknown datasets raise immediately. Normalization stats are the reference's
literal values: CIFAR-100 uses the ImageNet stats as written
(load_data.py:51), CIFAR-10 the CIFAR stats (load_data.py:61).
"""

from __future__ import annotations

import os
import pickle
import queue
import tarfile
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

# Surface parity: the reference's load_data.py also exposes a raw COCO
# dataset class (load_data.py:87-135); ours lives with the COCO stack.
from vision_transformers_tpu_torch.utils.coco.build_coco import (  # noqa: F401
    CocoDetection,
)

_STATS = {
    "cifar100": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "cifar10": ((0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)),
    "imagenet100": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "imagenet1000": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
}


# --------------------------------------------------------------------------
# raw dataset loading
# --------------------------------------------------------------------------

def _load_cifar(root_dir: str, name: str, train: bool):
    """Read CIFAR-10/100 python-pickle batches → (N,32,32,3) uint8, labels."""
    if name == "cifar100":
        base = os.path.join(root_dir, "cifar-100-python")
        files = ["train"] if train else ["test"]
        label_key = b"fine_labels"
    else:
        base = os.path.join(root_dir, "cifar-10-batches-py")
        files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        label_key = b"labels"

    if not os.path.isdir(base):
        tar = {
            "cifar100": "cifar-100-python.tar.gz",
            "cifar10": "cifar-10-python.tar.gz",
        }[name]
        tar_path = os.path.join(root_dir, tar)
        if os.path.isfile(tar_path):
            with tarfile.open(tar_path) as tf:
                tf.extractall(root_dir)
        else:
            raise FileNotFoundError(
                f"{name} not found under {root_dir!r}: expected {base} or "
                f"{tar_path} (this environment has no network egress — "
                f"place the standard CIFAR archive there)"
            )

    images, labels = [], []
    for f in files:
        with open(os.path.join(base, f), "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        images.append(d[b"data"])
        labels.extend(d[label_key])
    x = np.concatenate(images).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x), np.asarray(labels, np.int32)


def _list_imagefolder(root: str):
    """(paths, labels, class_names) for a torchvision-style image folder."""
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    paths, labels = [], []
    for i, c in enumerate(classes):
        cdir = os.path.join(root, c)
        for f in sorted(os.listdir(cdir)):
            if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp", ".webp")):
                paths.append(os.path.join(cdir, f))
                labels.append(i)
    return paths, np.asarray(labels, np.int32), classes


# --------------------------------------------------------------------------
# batched numpy augmentations
# --------------------------------------------------------------------------

def random_crop_batch(x: np.ndarray, rng: np.random.RandomState, pad: int = 4):
    """RandomCrop(size, padding=pad) over a uint8 NHWC batch."""
    n, h, w, c = x.shape
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="constant")
    ys = rng.randint(0, 2 * pad + 1, n)
    xs = rng.randint(0, 2 * pad + 1, n)
    idx_h = ys[:, None] + np.arange(h)[None, :]
    idx_w = xs[:, None] + np.arange(w)[None, :]
    out = xp[np.arange(n)[:, None, None], idx_h[:, :, None], idx_w[:, None, :]]
    return out


def random_hflip_batch(x: np.ndarray, rng: np.random.RandomState, p=0.5):
    flip = rng.rand(x.shape[0]) < p
    x = x.copy()
    x[flip] = x[flip, :, ::-1]
    return x


def brightness_jitter_batch(x: np.ndarray, rng: np.random.RandomState,
                            brightness: float = 63 / 255):
    """ColorJitter(brightness=b): multiply by U[1-b, 1+b] per image."""
    f = rng.uniform(1 - brightness, 1 + brightness, (x.shape[0], 1, 1, 1))
    return np.clip(x.astype(np.float32) * f, 0, 255).astype(np.uint8)


def _resize_bilinear(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """uint8 HWC bilinear resize via PIL (host decode path only)."""
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))


def random_resized_crop(img: np.ndarray, rng: np.random.RandomState,
                        size: int = 224, scale=(0.08, 1.0),
                        ratio=(3 / 4, 4 / 3)) -> np.ndarray:
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = rng.uniform(*scale) * area
        ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            y = rng.randint(0, h - ch + 1)
            x = rng.randint(0, w - cw + 1)
            return _resize_bilinear(img[y:y + ch, x:x + cw], size, size)
    # fallback: center crop
    s = min(h, w)
    y, x = (h - s) // 2, (w - s) // 2
    return _resize_bilinear(img[y:y + s, x:x + s], size, size)


def resize_center_crop(img: np.ndarray, resize: int = 256,
                       crop: int = 224) -> np.ndarray:
    h, w = img.shape[:2]
    if h < w:
        nh, nw = resize, int(round(w * resize / h))
    else:
        nh, nw = int(round(h * resize / w)), resize
    img = _resize_bilinear(img, nh, nw)
    y, x = (nh - crop) // 2, (nw - crop) // 2
    return img[y:y + crop, x:x + crop]


# --------------------------------------------------------------------------
# loaders
# --------------------------------------------------------------------------

class ArrayLoader:
    """Re-iterable prefetching loader over in-memory arrays (CIFAR).

    Each epoch: optional shuffle, batched vectorized augmentation in a
    producer thread (depth-2 queue) overlapping host augmentation with
    device compute.
    """

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, *, shuffle: bool, augment: bool,
                 normalize, seed: int = 0, prefetch: int = 2):
        self.images = images
        self.labels = labels
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.augment = augment
        self.normalize = normalize
        self.prefetch = prefetch
        self._epoch = 0
        self._seed = seed
        self.dataset = images  # len(loader.dataset) parity

    def __len__(self):
        return (len(self.labels) + self.batch_size - 1) // self.batch_size

    def _produce(self, q: "queue.Queue", rng: np.random.RandomState):
        order = np.arange(len(self.labels))
        if self.shuffle:
            rng.shuffle(order)
        try:
            for i in range(0, len(order), self.batch_size):
                idx = order[i:i + self.batch_size]
                x = self.images[idx]
                if self.augment:
                    # native fused crop+flip+jitter (single pass, C++);
                    # numpy three-pass fallback is seed-compatible
                    from vision_transformers_tpu_torch import native

                    fused = native.fused_augment(x, rng)
                    if fused is not None:
                        x = fused
                    else:
                        x = random_crop_batch(x, rng)
                        x = random_hflip_batch(x, rng)
                        x = brightness_jitter_batch(x, rng)
                q.put((x, self.labels[idx]))
        finally:
            q.put(None)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        self._epoch += 1
        rng = np.random.RandomState(self._seed + self._epoch)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=self._produce, args=(q, rng), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            yield item


class ImageFolderLoader:
    """Prefetching loader decoding an image-folder dataset per batch
    (imagenet-style recipes, load_data.py:66-84)."""

    def __init__(self, paths: Sequence[str], labels: np.ndarray,
                 batch_size: int, *, shuffle: bool, train: bool,
                 normalize, image_size: int = 224, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 2):
        self.paths = list(paths)
        self.labels = labels
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.train = train
        self.normalize = normalize
        self.image_size = image_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self._seed = seed
        self._epoch = 0
        self.dataset = self.paths

    def __len__(self):
        return (len(self.paths) + self.batch_size - 1) // self.batch_size

    def _decode_one(self, path: str, rng: np.random.RandomState) -> np.ndarray:
        from PIL import Image

        img = np.asarray(Image.open(path).convert("RGB"))
        if self.train:
            out = random_resized_crop(img, rng, self.image_size)
            if rng.rand() < 0.5:
                out = out[:, ::-1]
            return out
        return resize_center_crop(img, crop=self.image_size)

    def _produce(self, q, rng):
        from concurrent.futures import ThreadPoolExecutor

        order = np.arange(len(self.paths))
        if self.shuffle:
            rng.shuffle(order)
        try:
            with ThreadPoolExecutor(self.num_workers) as ex:
                for i in range(0, len(order), self.batch_size):
                    idx = order[i:i + self.batch_size]
                    seeds = rng.randint(0, 2 ** 31, len(idx))
                    imgs = list(ex.map(
                        lambda a: self._decode_one(
                            self.paths[a[0]], np.random.RandomState(a[1])
                        ),
                        zip(idx, seeds),
                    ))
                    q.put((np.stack(imgs), self.labels[idx]))
        finally:
            q.put(None)

    def __iter__(self):
        self._epoch += 1
        rng = np.random.RandomState(self._seed + self._epoch)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=self._produce, args=(q, rng), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            yield item


def shard_for_process(images, labels, seed: int = 0):
    """Each process's shard of a dataset for multi-process data parallelism
    (in place of a DistributedSampler): rank r keeps every world_size-th
    example of the fixed permutation ``RandomState(seed).permutation``,
    starting at r, index for index the JAX function's. The identity in one
    process."""
    from vision_transformers_tpu_torch.parallel.distributed import (
        get_rank,
        get_world_size,
    )

    world = get_world_size()
    if world == 1:
        return images, labels
    perm = np.random.RandomState(seed).permutation(len(labels))
    mine = perm[get_rank()::world]
    return images[mine], labels[mine]


def get_train_test_loaders(dataset_name: str = "cifar100", batch_size: int = 128,
                           num_workers: int = 8, val_split: Optional[float] = None,
                           root_dir: str = "../../data", seed: int = 0,
                           shard_by_process: bool = False):
    """Reference-surface loader factory (load_data.py:11-44).

    ``shard_by_process=True`` gives each host a disjoint shard of the train
    split (multi-host data parallelism)."""
    name = dataset_name.lower()
    if name not in _STATS:
        raise ValueError(f"Dataset {dataset_name} is not supported.")
    normalize = _STATS[name]

    if name in ("cifar100", "cifar10"):
        train_x, train_y = _load_cifar(root_dir, name, train=True)
        test_x, test_y = _load_cifar(root_dir, name, train=False)
        if shard_by_process:
            train_x, train_y = shard_for_process(train_x, train_y, seed)

        if val_split:
            n = len(train_y)
            n_val = int(n * val_split)
            rng = np.random.RandomState(seed)
            perm = rng.permutation(n)
            val_idx, train_idx = perm[:n_val], perm[n_val:]
            train_loader = ArrayLoader(
                train_x[train_idx], train_y[train_idx], batch_size,
                shuffle=True, augment=True, normalize=normalize, seed=seed)
            val_loader = ArrayLoader(
                train_x[val_idx], train_y[val_idx], batch_size,
                shuffle=False, augment=False, normalize=normalize)
            test_loader = ArrayLoader(
                test_x, test_y, batch_size,
                shuffle=False, augment=False, normalize=normalize)
            return train_loader, val_loader, test_loader

        train_loader = ArrayLoader(
            train_x, train_y, batch_size,
            shuffle=True, augment=True, normalize=normalize, seed=seed)
        test_loader = ArrayLoader(
            test_x, test_y, batch_size,
            shuffle=False, augment=False, normalize=normalize)
        return train_loader, test_loader

    # imagenet-style folder datasets
    train_root = os.path.join(root_dir, dataset_name, "train")
    test_root = os.path.join(root_dir, dataset_name, "val")
    tr_paths, tr_labels, _ = _list_imagefolder(train_root)
    te_paths, te_labels, _ = _list_imagefolder(test_root)

    def folder_loader(paths, labels, train, shuffle):
        return ImageFolderLoader(
            paths, labels, batch_size, shuffle=shuffle, train=train,
            normalize=normalize, num_workers=num_workers, seed=seed)

    if val_split:
        n = len(tr_paths)
        n_val = int(n * val_split)
        rng = np.random.RandomState(seed)
        perm = rng.permutation(n)
        val_idx, train_idx = perm[:n_val], perm[n_val:]
        tr = folder_loader([tr_paths[i] for i in train_idx],
                           tr_labels[train_idx], True, True)
        va = folder_loader([tr_paths[i] for i in val_idx],
                           tr_labels[val_idx], False, False)
        te = folder_loader(te_paths, te_labels, False, False)
        return tr, va, te
    return (folder_loader(tr_paths, tr_labels, True, True),
            folder_loader(te_paths, te_labels, False, False))
