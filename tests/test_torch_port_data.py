"""The port's input pipeline against the JAX package's: the CIFAR pickle
reader, the image-folder listing and loader, ``ArrayLoader`` on the native
(``augment.cpp``, the port's own build) and the numpy augmentation paths,
and the on-device augmentation given the same draws. Everything is
bit-equal: both packages run the same numpy, PIL and C++ arithmetic from
the same seeds.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu import native as jnative
from vision_transformers_tpu.training import device_data as jdd
from vision_transformers_tpu.utils import load_data as jld
from vision_transformers_tpu_torch import native as tnative
from vision_transformers_tpu_torch.training import device_data as tdd
from vision_transformers_tpu_torch.utils import load_data as tld


def write_cifar(root, name, n_train, n_test, seed=0):
    """The standard python-pickle batches of CIFAR-100 (``train``,
    ``test``, ``fine_labels``) or CIFAR-10 (``data_batch_1..5``,
    ``test_batch``, ``labels``), bytes keys, random pixels."""
    rng = np.random.RandomState(seed)
    if name == "cifar100":
        base = os.path.join(root, "cifar-100-python")
        files = {"train": n_train, "test": n_test}
        key, classes = b"fine_labels", 100
    else:
        base = os.path.join(root, "cifar-10-batches-py")
        files = {f"data_batch_{i}": n_train // 5 for i in range(1, 6)}
        files["test_batch"] = n_test
        key, classes = b"labels", 10
    os.makedirs(base, exist_ok=True)
    for f, n in files.items():
        d = {b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
             key: rng.randint(0, classes, n).tolist()}
        with open(os.path.join(base, f), "wb") as fh:
            pickle.dump(d, fh)


@pytest.mark.parametrize("name", ["cifar100", "cifar10"])
def test_cifar_reader_matches_jax(tmp_path, name):
    write_cifar(str(tmp_path), name, 40, 10)
    for train in (True, False):
        got = tld._load_cifar(str(tmp_path), name, train)
        want = jld._load_cifar(str(tmp_path), name, train)
        assert got[0].shape == ((40 if train else 10), 32, 32, 3)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].dtype == np.int32
    with pytest.raises(FileNotFoundError, match="cifar-100-python"):
        tld._load_cifar(str(tmp_path / "none"), "cifar100", True)


def test_native_augment_matches_the_numpy_pipeline():
    """The port's ``augment.cpp``, built into ``csrc/build``, against the
    JAX package's numpy three-pass path from the same seed."""
    assert tnative.available()
    assert str(tnative._lib_path()).startswith(str(tnative._BUILD_DIR))
    x = np.random.RandomState(0).randint(0, 256, (16, 32, 32, 3), np.uint8)
    got = tnative.fused_augment(x, np.random.RandomState(42))
    rng = np.random.RandomState(42)
    want = jld.brightness_jitter_batch(
        jld.random_hflip_batch(jld.random_crop_batch(x, rng), rng), rng)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_array_loader_matches_jax(monkeypatch, path):
    if path == "numpy":
        monkeypatch.setattr(tnative, "fused_augment", lambda *a, **k: None)
        monkeypatch.setattr(jnative, "fused_augment", lambda *a, **k: None)
    x = np.random.RandomState(1).randint(0, 256, (50, 32, 32, 3), np.uint8)
    y = np.arange(50, dtype=np.int32)
    kw = dict(shuffle=True, augment=True, normalize=((0.5,) * 3, (0.2,) * 3),
              seed=7)
    got_loader = tld.ArrayLoader(x, y, 16, **kw)
    want_loader = jld.ArrayLoader(x, y, 16, **kw)
    assert len(got_loader) == 4 and got_loader.normalize == kw["normalize"]
    for _ in range(2):  # two epochs: a new permutation and new draws
        got, want = list(got_loader), list(want_loader)
        assert [b[0].shape[0] for b in got] == [16, 16, 16, 2]
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx.dtype == np.uint8
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def _write_folder(root, classes=2, per_class=3, seed=0):
    from PIL import Image

    rng = np.random.RandomState(seed)
    for c in range(classes):
        d = os.path.join(root, f"class{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            h, w = rng.randint(40, 80, 2)
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(d, f"{i}.png"))
        with open(os.path.join(d, "notes.txt"), "w") as fh:
            fh.write("not an image")


def test_image_folder_loader_matches_jax(tmp_path):
    _write_folder(str(tmp_path))
    paths, labels, classes = tld._list_imagefolder(str(tmp_path))
    want = jld._list_imagefolder(str(tmp_path))
    assert paths == want[0] and classes == want[2] == ["class0", "class1"]
    np.testing.assert_array_equal(labels, want[1])
    for train in (True, False):
        kw = dict(shuffle=train, train=train, normalize=None, image_size=32,
                  seed=3, num_workers=2)
        got = list(tld.ImageFolderLoader(paths, labels, 4, **kw))
        ref = list(jld.ImageFolderLoader(paths, labels, 4, **kw))
        assert [g[0].shape for g in got] == [(4, 32, 32, 3), (2, 32, 32, 3)]
        for (gx, gy), (wx, wy) in zip(got, ref):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def test_get_train_test_loaders_split_as_jax(tmp_path):
    write_cifar(str(tmp_path), "cifar10", 50, 10)
    got = tld.get_train_test_loaders("cifar10", 8, 2, 0.2, str(tmp_path))
    want = jld.get_train_test_loaders("cifar10", 8, 2, 0.2, str(tmp_path))
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.labels, w.labels)
        assert g.normalize == w.normalize == tld._STATS["cifar10"]
    with pytest.raises(ValueError, match="not supported"):
        tld.get_train_test_loaders("mnist", 8)
    x, y = np.zeros((4, 2)), np.arange(4)
    assert tld.shard_for_process(x, y)[0] is x  # one process: the identity


def test_device_augment_matches_jax_given_its_draws():
    """``apply_augment`` fed the draws JAX's ``augment_batch_on_device``
    makes from one key (crop offsets, flips, factors) gives its output."""
    b, pad = 8, 4
    images = np.random.RandomState(2).randint(0, 256, (b, 32, 32, 3),
                                              np.uint8)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jdd.augment_batch_on_device(jnp.asarray(images), key))
    r_crop, r_flip, r_bright = jax.random.split(key, 3)
    ys = jax.random.randint(r_crop, (b, 1), 0, 2 * pad + 1)[:, 0]
    xs = jax.random.randint(jax.random.fold_in(r_crop, 1), (b, 1), 0,
                            2 * pad + 1)[:, 0]
    flips = jax.random.bernoulli(r_flip, 0.5, (b, 1, 1, 1)).reshape(b)
    f = jax.random.uniform(r_bright, (b, 1, 1, 1), minval=1 - 63 / 255,
                           maxval=1 + 63 / 255).reshape(b)
    assert 0 < int(np.sum(flips)) < b  # both branches taken
    got = tdd.apply_augment(
        torch.from_numpy(images), *(torch.from_numpy(np.array(a))
                                    for a in (ys, xs, flips, f)), pad)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_device_augment_draws_from_its_generator():
    images = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (6, 32, 32, 3), np.uint8))

    def run(seed):
        return tdd.augment_batch_on_device(
            images, torch.Generator().manual_seed(seed))

    a = run(5)
    assert a.shape == (6, 32, 32, 3) and float(a.min()) >= 0.0 \
        and float(a.max()) <= 255.0
    assert torch.equal(a, run(5)) and not torch.equal(a, run(6))
