"""COCO detection dataset (pycocotools-free).

Counterpart of ``vision_transformers_tpu/utils/coco/build_coco.py``, this
package's own copy (the port imports nothing of the JAX package).

Same capability surface as the reference's vendored DETR dataset
(utils/coco/build_coco.py:17-158): a CocoDetection dataset that injects
``image_id``, canonicalizes targets via ``ConvertCocoPolysToMask``
(xywh→xyxy clamp build_coco.py:66-69, crowd filter :62, degenerate-box
filter :86-92, optional polygon/RLE→mask :33-47, keypoints :78-84,
area/iscrowd/orig_size fields :104-110), the 11-scale train transform
recipe (:115-144) and a ``build()`` path wiring function (:147-158).

pycocotools is not in this environment, so the annotation index is built
from the JSON with the stdlib, polygons are rasterized with PIL.ImageDraw,
and both uncompressed and compressed COCO RLE are decoded in numpy.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from vision_transformers_tpu_torch.utils.coco import transforms as T

SCALES = [480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800]


# ----------------------------------------------------------------- RLE / masks

def decode_compressed_rle(rle_str, h: int, w: int) -> np.ndarray:
    """Decode COCO compressed RLE (the LEB128-style byte encoding used by
    pycocotools' frString) into an (h, w) uint8 mask."""
    if isinstance(rle_str, str):
        rle_str = rle_str.encode()
    counts = []
    i = 0
    while i < len(rle_str):
        x = 0
        k = 0
        more = True
        while more:
            c = rle_str[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return _counts_to_mask(counts, h, w)


def _counts_to_mask(counts: List[int], h: int, w: int) -> np.ndarray:
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        flat[pos:pos + c] = val
        pos += c
        val = 1 - val
    # COCO RLE is column-major
    return flat.reshape(w, h).T


def polygons_to_mask(polygons: List, h: int, w: int) -> np.ndarray:
    """Rasterize COCO polygon segmentation with PIL (pycocotools-free)."""
    from PIL import Image, ImageDraw

    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, np.uint8)


def segmentation_to_mask(seg, h: int, w: int) -> np.ndarray:
    if isinstance(seg, list):
        return polygons_to_mask(seg, h, w)
    counts = seg.get("counts")
    sh, sw = seg.get("size", (h, w))
    if isinstance(counts, list):
        return _counts_to_mask(counts, sh, sw)
    return decode_compressed_rle(counts, sh, sw)


def convert_coco_poly_to_mask(segmentations, height, width) -> np.ndarray:
    masks = [
        segmentation_to_mask(seg, height, width) for seg in segmentations
    ]
    if not masks:
        return np.zeros((0, height, width), bool)
    return np.stack(masks).astype(bool)


# -------------------------------------------------------------------- dataset

class CocoIndex:
    """Minimal pycocotools.COCO replacement over an annotation JSON."""

    def __init__(self, annotation_file: str):
        with open(annotation_file) as f:
            d = json.load(f)
        self.imgs = {im["id"]: im for im in d.get("images", [])}
        self.anns = {a["id"]: a for a in d.get("annotations", [])}
        self.cats = {c["id"]: c for c in d.get("categories", [])}
        self.img_to_anns: Dict[int, List[dict]] = {i: [] for i in self.imgs}
        for a in d.get("annotations", []):
            self.img_to_anns.setdefault(a["image_id"], []).append(a)

    def getImgIds(self):
        return sorted(self.imgs)

    def loadImgs(self, ids):
        ids = ids if isinstance(ids, (list, tuple)) else [ids]
        return [self.imgs[i] for i in ids]

    def loadAnns(self, ids):
        ids = ids if isinstance(ids, (list, tuple)) else [ids]
        return [self.anns[i] for i in ids]

    def getAnnIds(self, imgIds):
        ids = imgIds if isinstance(imgIds, (list, tuple)) else [imgIds]
        return [a["id"] for i in ids for a in self.img_to_anns.get(i, [])]


class ConvertCocoPolysToMask:
    """Target canonicalization (build_coco.py:50-112 semantics)."""

    def __init__(self, return_masks: bool = False):
        self.return_masks = return_masks

    def __call__(self, image: np.ndarray, target: Dict):
        h, w = image.shape[:2]
        image_id = target["image_id"]
        anno = [
            a for a in target["annotations"]
            if a.get("iscrowd", 0) == 0
        ]

        boxes = np.asarray(
            [a["bbox"] for a in anno], np.float32).reshape(-1, 4)
        # xywh → xyxy, clamp to image
        boxes[:, 2:] += boxes[:, :2]
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)

        classes = np.asarray(
            [a["category_id"] for a in anno], np.int64)

        masks = None
        if self.return_masks:
            masks = convert_coco_poly_to_mask(
                [a["segmentation"] for a in anno], h, w)

        keypoints = None
        if anno and "keypoints" in anno[0]:
            keypoints = np.asarray(
                [a["keypoints"] for a in anno], np.float32)
            if keypoints.size:
                keypoints = keypoints.reshape(len(anno), -1, 3)

        keep = (boxes[:, 3] > boxes[:, 1]) & (boxes[:, 2] > boxes[:, 0])
        boxes = boxes[keep]
        classes = classes[keep]
        if masks is not None:
            masks = masks[keep]
        if keypoints is not None:
            keypoints = keypoints[keep]

        out = {
            "boxes": boxes,
            "labels": classes,
            "image_id": np.asarray([image_id]),
            "area": np.asarray([a["area"] for a in anno], np.float32)[keep],
            "iscrowd": np.asarray(
                [a.get("iscrowd", 0) for a in anno], np.int64)[keep],
            "orig_size": np.asarray([h, w]),
            "size": np.asarray([h, w]),
        }
        if masks is not None:
            out["masks"] = masks
        if keypoints is not None:
            out["keypoints"] = keypoints
        return image, out


class CocoDetection:
    """Map-style dataset yielding (image float32 CHW, target dict)."""

    def __init__(self, img_folder: str, ann_file: str, transforms=None,
                 return_masks: bool = False):
        self.img_folder = img_folder
        self.coco = CocoIndex(ann_file)
        self.ids = self.coco.getImgIds()
        self._transforms = transforms
        self.prepare = ConvertCocoPolysToMask(return_masks)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx: int):
        from PIL import Image

        image_id = self.ids[idx]
        info = self.coco.loadImgs(image_id)[0]
        path = os.path.join(self.img_folder, info["file_name"])
        image = np.asarray(Image.open(path).convert("RGB"))
        anns = self.coco.img_to_anns.get(image_id, [])
        target = {"image_id": image_id, "annotations": anns}
        image, target = self.prepare(image, target)
        if self._transforms is not None:
            image, target = self._transforms(image, target)
        return image, target


def make_coco_transforms(image_set: str):
    """Train: hflip → RandomSelect(multi-scale resize | resize→crop→resize)
    → ToTensor → Normalize; val: resize 800 (build_coco.py:115-144)."""
    normalize = T.Compose([
        T.ToTensor(),
        T.Normalize([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
    ])
    if image_set == "train":
        return T.Compose([
            T.RandomHorizontalFlip(),
            T.RandomSelect(
                T.RandomResize(SCALES, max_size=1333),
                T.Compose([
                    T.RandomResize([400, 500, 600]),
                    T.RandomSizeCrop(384, 600),
                    T.RandomResize(SCALES, max_size=1333),
                ]),
            ),
            normalize,
        ])
    if image_set == "val":
        return T.Compose([
            T.RandomResize([800], max_size=1333),
            normalize,
        ])
    raise ValueError(f"unknown {image_set}")


def build(image_set: str, coco_path: str, return_masks: bool = False):
    """Path wiring (build_coco.py:147-158)."""
    root = coco_path
    mode = "instances"
    paths = {
        "train": (os.path.join(root, "train2017"),
                  os.path.join(root, "annotations", f"{mode}_train2017.json")),
        "val": (os.path.join(root, "val2017"),
                os.path.join(root, "annotations", f"{mode}_val2017.json")),
    }
    img_folder, ann_file = paths[image_set]
    return CocoDetection(
        img_folder, ann_file,
        transforms=make_coco_transforms(image_set),
        return_masks=return_masks,
    )
