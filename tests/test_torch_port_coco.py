"""The port's COCO dataset (``utils/coco/build_coco.py``,
``utils/coco/transforms.py``) against the JAX package's: compressed and
uncompressed RLE, polygons, the crowd and degenerate-box filters, the
train and val transforms under one ``RandomState``, and ``build`` on a
folder written in the test. Both are numpy and PIL: bit-equal.
"""

import json
import os

import numpy as np
import pytest

from vision_transformers_tpu.utils.coco import build_coco as jbc
from vision_transformers_tpu.utils.coco import transforms as jT
from vision_transformers_tpu_torch.utils.coco import build_coco as tbc
from vision_transformers_tpu_torch.utils.coco import transforms as tT


def rle_counts(mask):
    """Uncompressed COCO RLE counts of a (h, w) 0/1 mask (column-major,
    starting with a run of zeros)."""
    flat = mask.T.reshape(-1)
    counts, val, run = [], 0, 0
    for v in flat:
        if v != val:
            counts.append(run)
            val, run = v, 0
        run += 1
    counts.append(run)
    return counts


def rle_string(counts):
    """pycocotools' rleToString: deltas of counts two back, 5-bit groups,
    a continuation bit, offset 48."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if c & 0x10 else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def _mask(seed, h=23, w=31):
    rng = np.random.RandomState(seed)
    m = np.zeros((h, w), np.uint8)
    for _ in range(4):
        y, x = rng.randint(0, h - 5), rng.randint(0, w - 5)
        m[y:y + rng.randint(2, 6), x:x + rng.randint(2, 6)] = 1
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle_decodes_as_jax(seed):
    m = _mask(seed)
    counts = rle_counts(m)
    for seg in ({"counts": counts, "size": list(m.shape)},
                {"counts": rle_string(counts), "size": list(m.shape)}):
        got = tbc.segmentation_to_mask(seg, *m.shape)
        np.testing.assert_array_equal(got, m)
        np.testing.assert_array_equal(
            got, jbc.segmentation_to_mask(seg, *m.shape))


def test_polygons_rasterize_as_jax():
    polys = [[2, 2, 20, 3, 15, 18, 4, 12], [25, 5, 30, 5, 28, 10],
             [1, 1, 2, 2]]  # the last has 2 points: skipped
    got = tbc.polygons_to_mask(polys, 23, 31)
    np.testing.assert_array_equal(got, jbc.polygons_to_mask(polys, 23, 31))
    assert got.sum() > 50
    np.testing.assert_array_equal(
        tbc.convert_coco_poly_to_mask([polys, polys[:1]], 23, 31),
        jbc.convert_coco_poly_to_mask([polys, polys[:1]], 23, 31))
    assert tbc.convert_coco_poly_to_mask([], 5, 6).shape == (0, 5, 6)


def _anns():
    m = _mask(3, 40, 60)
    return [
        {"id": 1, "image_id": 7, "bbox": [5, 6, 20, 10], "category_id": 3,
         "area": 200.0, "iscrowd": 0,
         "segmentation": [[5, 6, 25, 6, 25, 16, 5, 16]]},
        {"id": 2, "image_id": 7, "bbox": [50, 30, 30, 30], "category_id": 5,
         "area": 900.0, "iscrowd": 0,  # clamped to the image
         "segmentation": {"counts": rle_counts(m), "size": [40, 60]}},
        {"id": 3, "image_id": 7, "bbox": [1, 1, 10, 10], "category_id": 2,
         "area": 100.0, "iscrowd": 1,  # crowd: dropped
         "segmentation": {"counts": rle_string(rle_counts(m)),
                          "size": [40, 60]}},
        {"id": 4, "image_id": 7, "bbox": [10, 10, 0, 5], "category_id": 4,
         "area": 0.0, "iscrowd": 0,  # degenerate: dropped
         "segmentation": [[10, 10, 10, 15, 10, 12]]},
    ]


def _same_target(got, want):
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("masks", [False, True])
def test_target_canonicalisation_as_jax(masks):
    image = np.zeros((40, 60, 3), np.uint8)
    target = {"image_id": 7, "annotations": _anns()}
    _, got = tbc.ConvertCocoPolysToMask(masks)(image, target)
    _, want = jbc.ConvertCocoPolysToMask(masks)(image, target)
    _same_target(got, want)
    assert got["labels"].tolist() == [3, 5]
    np.testing.assert_array_equal(got["boxes"][1], [50, 30, 60, 40])
    if masks:
        assert got["masks"].shape == (2, 40, 60)


@pytest.mark.parametrize("image_set", ["train", "val"])
def test_transforms_as_jax_under_one_random_state(image_set):
    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, (40, 60, 3)).astype(np.uint8)
    _, target = jbc.ConvertCocoPolysToMask(True)(
        image, {"image_id": 7, "annotations": _anns()[:2]})
    for seed in range(4):  # both RandomSelect branches, flips or not
        got = tbc.make_coco_transforms(image_set)(
            image, dict(target), np.random.RandomState(seed))
        want = jbc.make_coco_transforms(image_set)(
            image, dict(target), np.random.RandomState(seed))
        assert got[0].dtype == np.float32 and got[0].shape[0] == 3
        np.testing.assert_array_equal(got[0], want[0])
        _same_target(got[1], want[1])


def test_each_transform_as_jax():
    rng = np.random.RandomState(1)
    image = rng.randint(0, 256, (40, 60, 3)).astype(np.uint8)
    _, target = jbc.ConvertCocoPolysToMask(True)(
        image, {"image_id": 7, "annotations": _anns()[:2]})
    for name, args in (("RandomCrop", ((30, 40),)),
                       ("RandomSizeCrop", (20, 45)),
                       ("CenterCrop", ((30, 30),)),
                       ("RandomPad", (10,)), ("RandomErasing", (1.0,))):
        got = getattr(tT, name)(*args)(image, dict(target),
                                       np.random.RandomState(2))
        want = getattr(jT, name)(*args)(image, dict(target),
                                        np.random.RandomState(2))
        np.testing.assert_array_equal(got[0], want[0], err_msg=name)
        _same_target(got[1], want[1])


def write_coco(root, n_images=3, seed=0, size=(48, 64)):
    """A COCO folder: ``train2017/``, ``val2017/`` and
    ``annotations/instances_{train,val}2017.json`` with boxes, polygons,
    compressed and uncompressed RLE and a crowd annotation."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    h, w = size
    for split in ("train", "val"):
        os.makedirs(os.path.join(root, f"{split}2017"), exist_ok=True)
        images, anns = [], []
        for i in range(n_images):
            name = f"{i:012d}.jpg"
            Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(
                np.uint8)).save(os.path.join(root, f"{split}2017", name))
            images.append({"id": i + 1, "file_name": name, "height": h,
                           "width": w})
            m = _mask(i, h, w)
            for j, seg in enumerate((
                    [[4, 4, 30, 4, 30, 20, 4, 20]],
                    {"counts": rle_counts(m), "size": [h, w]},
                    {"counts": rle_string(rle_counts(m)), "size": [h, w]})):
                x0, y0 = rng.randint(0, w // 2), rng.randint(0, h // 2)
                anns.append({"id": len(anns) + 1, "image_id": i + 1,
                             "bbox": [x0, y0, rng.randint(4, w // 2),
                                      rng.randint(4, h // 2)],
                             "category_id": int(rng.randint(1, 91)),
                             "area": 50.0, "iscrowd": int(j == 2),
                             "segmentation": seg})
        os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
        with open(os.path.join(root, "annotations",
                               f"instances_{split}2017.json"), "w") as fh:
            json.dump({"images": images, "annotations": anns,
                       "categories": [{"id": c, "name": str(c)}
                                      for c in range(1, 91)]}, fh)


def test_build_reads_a_coco_folder_as_jax(tmp_path):
    write_coco(str(tmp_path))
    got_ds = tbc.build("val", str(tmp_path), return_masks=True)
    want_ds = jbc.build("val", str(tmp_path), return_masks=True)
    assert len(got_ds) == len(want_ds) == 3
    for i in range(3):
        got, want = got_ds[i], want_ds[i]
        np.testing.assert_array_equal(got[0], want[0])
        _same_target(got[1], want[1])
    idx = tbc.CocoIndex(os.path.join(str(tmp_path), "annotations",
                                     "instances_val2017.json"))
    assert idx.getImgIds() == [1, 2, 3] and len(idx.getAnnIds(2)) == 3
    with pytest.raises(ValueError, match="unknown"):
        tbc.make_coco_transforms("test")
