"""The PyTorch port's serving path, and the port's isolation from JAX.

Export → load → padded/chunked predict → micro-batching on
``device="cpu"``, where attention takes the kernels' plain versions. The
logits are held against the JAX package's ViT with the same weights
(fp32, 1e-4).
"""

import json
import os
import pathlib
import re
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.models.image_classification import ViT as JViT
from vision_transformers_tpu_torch import serving
from vision_transformers_tpu_torch.models.image_classification import (
    SwinTransformer,
    SwinTransformerV2,
    ViT,
)
from vision_transformers_tpu_torch.ops import flash_attention as tfa
from vision_transformers_tpu_torch.utils.port_jax import vit_state_dict_from_jax

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "vision_transformers_tpu_torch"
SHAPE = (16, 16, 3)
TINY = dict(image_size=16, patch_size=4, num_layers=2, num_heads=4,
            hidden_dim=32, mlp_dim=64, num_classes=10)
TOL = 1e-4


@pytest.fixture(scope="module")
def jax_model_and_params():
    model = JViT(**TINY)
    params = jax.device_get(
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, *SHAPE)))["params"])
    rng = np.random.RandomState(0)  # nonzero head: logits are not all 0
    params["head"]["kernel"] = rng.randn(32, 10).astype(np.float32) * 0.2
    params["head"]["bias"] = rng.randn(10).astype(np.float32) * 0.1
    return model, params


@pytest.fixture(scope="module")
def artifact(jax_model_and_params, tmp_path_factory):
    _, params = jax_model_and_params
    model = ViT(**TINY, device="cpu")
    model.load_state_dict(vit_state_dict_from_jax(params))
    out = str(tmp_path_factory.mktemp("artifact"))
    manifest = serving.export_classifier(model, SHAPE, out, buckets=(4, 2))
    return out, manifest


@pytest.fixture(scope="module")
def clf(artifact):
    return serving.load_classifier(artifact[0], device="cpu")


def _jax_logits(jax_model_and_params, x):
    model, params = jax_model_and_params
    return np.asarray(model.apply({"params": params}, jnp.asarray(x)))


def test_manifest_contents(artifact):
    out, manifest = artifact
    assert manifest["format_version"] == 1
    assert manifest["platforms"] == ["cuda"]
    assert manifest["buckets"] == [2, 4]
    assert manifest["input_shape"] == list(SHAPE)
    assert manifest["input_dtype"] == "float32"
    assert manifest["model"] == "ViT"
    assert manifest["model_kwargs"] == {**TINY, "dropout": 0.0,
                                        "attention_dropout": 0.0,
                                        "remat": False, "dtype": "float32",
                                        "in_channels": 3}
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f) == manifest
    assert os.path.exists(os.path.join(out, manifest["params_file"]))


def test_round_trip_exact_bucket(clf, jax_model_and_params):
    x = np.random.RandomState(1).randn(4, *SHAPE).astype(np.float32)
    got = clf.predict(x)
    assert got.shape == (4, 10) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), _jax_logits(jax_model_and_params, x),
                               atol=TOL, rtol=0)


def test_padding_and_chunking(clf, jax_model_and_params):
    rng = np.random.RandomState(2)
    for n in (1, 3, 4, 9):  # pad→2, pad→4, exact, chunk 4+4+pad(1→2)
        x = rng.randn(n, *SHAPE).astype(np.float32)
        got = clf.predict(x)
        assert got.shape == (n, 10)
        np.testing.assert_allclose(
            got.numpy(), _jax_logits(jax_model_and_params, x), atol=TOL, rtol=0)


def test_padding_does_not_change_real_rows(clf):
    x = np.random.RandomState(3).randn(3, *SHAPE).astype(np.float32)
    np.testing.assert_allclose(clf.predict(x).numpy(),
                               clf.predict(np.concatenate([x, x[:1]]))[:3].numpy(),
                               atol=1e-6, rtol=0)


def test_single_image_convenience(clf):
    out = clf.predict(np.zeros(SHAPE, np.float32))
    assert out.shape == (1, 10)


def test_bad_shape_raises(clf):
    with pytest.raises(ValueError, match="expected"):
        clf.predict(np.zeros((2, 8, 8, 3), np.float32))


def test_warmup_runs_every_bucket(clf, monkeypatch):
    seen = []
    real = clf._run_bucket
    monkeypatch.setattr(clf, "_run_bucket",
                        lambda b, x: seen.append((b, x.shape[0])) or real(b, x))
    clf.warmup()
    assert seen == [(2, 2), (4, 4)]


def test_microbatcher_matches_direct_predict(clf):
    rng = np.random.RandomState(4)
    imgs = rng.randn(7, *SHAPE).astype(np.float32)
    direct = clf.predict(imgs).numpy()
    mb = serving.Microbatcher(clf, max_wait_ms=20.0)
    results = [None] * len(imgs)

    def worker(i):
        results[i] = mb.submit(imgs[i])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(imgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    mb.close()
    for i in range(len(imgs)):
        np.testing.assert_allclose(results[i], direct[i], atol=1e-5, rtol=0)


def test_microbatcher_surfaces_errors_and_rejects_after_close(clf):
    mb = serving.Microbatcher(clf, max_wait_ms=1.0)
    with pytest.raises(ValueError, match="expected"):
        mb.submit(np.zeros((8, 8, 3), np.float32))
    mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(np.zeros(SHAPE, np.float32))


def test_load_classifier_without_device_raises_without_cuda(artifact,
                                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.load_classifier(artifact[0])


_NARROW_SWIN = dict(patch_size=[2, 2], embed_dim=8, depths=[1], num_heads=[2],
                    window_size=[4, 4], num_classes=3)


@pytest.mark.parametrize("build", [
    lambda: ViT(**TINY),
    lambda: SwinTransformer(**_NARROW_SWIN),
    lambda: SwinTransformerV2(**_NARROW_SWIN),
], ids=["ViT", "SwinTransformer", "SwinTransformerV2"])
def test_models_without_device_raise_without_cuda(build, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()


def test_load_rejects_other_format_version(artifact, tmp_path):
    out, manifest = artifact
    bad = dict(manifest, format_version=99)
    (tmp_path / "manifest.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="format"):
        serving.load_classifier(str(tmp_path), device="cpu")


def test_cpu_serving_launches_no_kernel(clf):
    tfa.reset_launch_counts()
    clf.predict(np.zeros((3, *SHAPE), np.float32))
    assert tfa.LAUNCHES["packed_attention"] == 0
    assert not any(tfa.LAUNCHES.values())


# ---------------------------------------------------------------------------
# Staging through the pinned ring: the plan here, the ring itself on the card
# (tests/test_torch_port_serving_cuda.py).

_IMAGE_224 = 224 * 224 * 3 * 4  # one fp32 ImageNet image, 602 112 bytes


@pytest.mark.parametrize("image_bytes,chunk_bytes,per", [
    (_IMAGE_224, serving.CHUNK_BYTES, 111),  # 64 MiB
    (_IMAGE_224, 16 << 20, 27),
    (3072, 12288, 4),  # whole images only
    (3072, 12287, 3),
    (3072, 3072, 1),
    (5000, 4096, 1),  # one image larger than a slot: the slot is one image
])
def test_images_per_chunk(image_bytes, chunk_bytes, per):
    assert serving.images_per_chunk(image_bytes, chunk_bytes) == per


@pytest.mark.parametrize("n,image_bytes,chunk_bytes,chunks", [
    (1, 3072, 12288, [(0, 1)]),
    (9, 3072, 12288, [(0, 4), (4, 8), (8, 9)]),  # ragged last chunk
    (8, 3072, 12288, [(0, 4), (4, 8)]),
    (3, 5000, 4096, [(0, 1), (1, 2), (2, 3)]),  # an image larger than a slot
    (256, _IMAGE_224, serving.CHUNK_BYTES,  # a scored batch: 3 chunks
     [(0, 111), (111, 222), (222, 256)]),
    (256, _IMAGE_224, 16 << 20,
     [(i, min(i + 27, 256)) for i in range(0, 256, 27)]),
])
def test_staging_chunks(n, image_bytes, chunk_bytes, chunks):
    got = serving.staging_chunks(n, image_bytes, chunk_bytes)
    assert got == chunks
    assert got[0][0] == 0 and got[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_cpu_predict_stages_nothing(clf, monkeypatch, dtype):
    """On the CPU a request takes the direct path: no ring, nothing counted,
    and a request of the input dtype reaches the model as numpy's memory
    (n 9 through buckets (2, 4): 4 + 4 + 1 padded to 4)."""
    seen = []
    real = clf._run_bucket
    monkeypatch.setattr(clf, "_run_bucket",
                        lambda b, x: seen.append((b, x)) or real(b, x))
    x = (np.random.RandomState(5).rand(9, *SHAPE) * 255).astype(dtype)
    got = clf.predict(x)
    assert [(b, t.shape[0]) for b, t in seen] == [(4, 4), (4, 4), (4, 1)]
    assert clf._ring is None and clf.staged_chunks == clf.staged_bytes == 0
    as_input = torch.as_tensor(x, dtype=torch.float32)
    assert torch.equal(torch.cat([t for _, t in seen]), as_input)
    if dtype == np.float32:
        assert seen[0][1].data_ptr() == x.ctypes.data
    assert torch.equal(got, torch.cat([real(4, as_input[i: i + 4])
                                       for i in range(0, 9, 4)]))


# ---------------------------------------------------------------------------
# The port imports nothing of JAX or of the JAX package.

_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(jax|flax|optax|orbax|vision_transformers_tpu)"
    r"(?![\w])", re.MULTILINE)


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_no_jax_in_a_fresh_process():
    zoo = "vision_transformers_tpu_torch.models.image_classification."
    assert {"vision_transformers_tpu_torch.ops.windows",
            "vision_transformers_tpu_torch.ops.fused_adam",
            "vision_transformers_tpu_torch.ops.sra",
            zoo + "swin_transformer", zoo + "pvt",
            zoo + "twins_svt", zoo + "deit", zoo + "cpe_vit",
            zoo + "t2t_vit", zoo + "token_performer",
            zoo + "token_transformer",
            "vision_transformers_tpu_torch.ops.fused_dense",
            "vision_transformers_tpu_torch.ops.posenc",
            "vision_transformers_tpu_torch.models.object_detection.detr",
            "vision_transformers_tpu_torch.models.object_detection.matcher",
            "vision_transformers_tpu_torch.training.detection",
            "vision_transformers_tpu_torch.utils.coco.coco_eval",
            "vision_transformers_tpu_torch.utils.metrics",
            "vision_transformers_tpu_torch.parallel"} | {
                f"vision_transformers_tpu_torch.parallel.{m}" for m in (
                    "distributed", "mesh", "sequence", "pipeline",
                    "expert")} <= set(_port_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "              'vision_transformers_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("text,bad", [
    ("import jax\n", True),
    ("from flax import linen\n", True),
    ("import vision_transformers_tpu.ops\n", True),
    ("from vision_transformers_tpu import serving\n", True),
    ("from vision_transformers_tpu_torch import serving\n", False),
    ("import vision_transformers_tpu_torch.ops.attention\n", False),
    ("import jaxtyping_free\n", False),
])
def test_forbidden_import_regex(text, bad):
    assert bool(_FORBIDDEN.search(text)) == bad


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f.relative_to(REPO)) for f in files
                 if _FORBIDDEN.search(f.read_text())]
    assert not offenders
