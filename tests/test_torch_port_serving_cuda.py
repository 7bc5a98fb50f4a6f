"""The port's serving path on the card: requests staged through the
classifier's pinned ring (``serving.ServingClassifier._stage``).

Every test here needs a CUDA device and skips without one (pinned memory
and DMA have no CPU mode; the chunk plan is tested on the CPU in
``tests/test_torch_port_serving.py``). The file imports no JAX, so it runs
where only PyTorch is installed; ``tests/conftest.py`` imports JAX, hence
``--noconftest``:

    python -m pytest tests/test_torch_port_serving_cuda.py -q --noconftest

Images are 224 × 224 × 3 (602 112 bytes in fp32), so a request of 256 is
staged in three chunks, 111 + 111 + 34, through the ring's two slots, the
third refilling the first.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from vision_transformers_tpu_torch import serving
from vision_transformers_tpu_torch.models.image_classification import ViT

SHAPE = (224, 224, 3)
SMALL = dict(image_size=224, patch_size=32, num_layers=1, num_heads=2,
             hidden_dim=32, mlp_dim=64, num_classes=10)
N = 256
IMAGE = 602112


@pytest.fixture(scope="module")
def card_clf(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (pinned staging has no CPU mode)")
    torch.manual_seed(0)
    model = ViT(**SMALL, device="cuda")
    with torch.no_grad():  # a zero-initialised head answers 0 for any image
        model.head.weight.normal_(0.0, 0.2)
        model.head.bias.normal_(0.0, 0.1)
    out = str(tmp_path_factory.mktemp("artifact"))
    serving.export_classifier(model, SHAPE, out, buckets=(8, N))
    clf = serving.load_classifier(out, device="cuda")
    clf.warmup()
    return clf


def _images(seed, n=N, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (n, *SHAPE), dtype=np.uint8)
    return rng.standard_normal((n, *SHAPE), dtype=np.float32).astype(dtype)


def _pinned(a):
    return torch.from_numpy(a).pin_memory()


_INPUTS = {
    "fp32": lambda: _images(1),
    "uint8": lambda: _images(2, dtype=np.uint8),  # cast into the slots
    "fp64": lambda: _images(3, dtype=np.float64),
    # NCHW transposed to NHWC, and every other image: strided views
    "transposed": lambda: np.ascontiguousarray(
        _images(4).transpose(0, 3, 1, 2)).transpose(0, 2, 3, 1),
    "every_other": lambda: _images(5, n=2 * N - 1)[::2],
    "one_image": lambda: _images(6, n=1)[0],
    "tensor": lambda: torch.from_numpy(_images(7)),
    "pinned": lambda: _pinned(_images(8)),  # one DMA, not staged
    "pinned_uint8": lambda: _pinned(_images(9, dtype=np.uint8)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_INPUTS))
def test_staged_input_is_bit_equal(card_clf, name):
    """What the forward gets equals the pageable copy's bits, for every kind
    of host input; only pinned contiguous input-dtype tensors skip the
    ring."""
    images = _INPUTS[name]()
    chunks, nbytes = card_clf.staged_chunks, card_clf.staged_bytes
    x = card_clf._to_device(images)
    want = torch.as_tensor(images, dtype=torch.float32).to("cuda")
    if want.ndim == 3:
        want = want[None]
    assert x.device.type == "cuda" and x.dtype == torch.float32
    assert torch.equal(x, want)
    n = want.shape[0]
    staged = name != "pinned"
    assert card_clf.staged_chunks - chunks == (
        len(serving.staging_chunks(n, IMAGE)) if staged else 0)
    assert card_clf.staged_bytes - nbytes == (n * IMAGE if staged else 0)


@pytest.mark.cuda
def test_device_input_is_not_staged(card_clf):
    x = torch.from_numpy(_images(10)).to("cuda")
    chunks = card_clf.staged_chunks
    assert torch.equal(card_clf._to_device(x), x)
    assert card_clf.staged_chunks == chunks


@pytest.mark.cuda
def test_back_to_back_requests_keep_their_own_logits(card_clf):
    """Two requests with no readback between them, queued behind a long
    kernel so that every DMA waits: the host must not refill a slot before
    the DMA that reads it has run."""
    a, b = _images(11), _images(12)
    ref_a = card_clf.predict(torch.from_numpy(a).to("cuda")).cpu()
    ref_b = card_clf.predict(torch.from_numpy(b).to("cuda")).cpu()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of the stream
    got_a = card_clf.predict(a)
    got_b = card_clf.predict(b)
    assert torch.equal(got_a.cpu(), ref_a)
    assert torch.equal(got_b.cpu(), ref_b)
    assert not torch.equal(ref_a, ref_b)


@pytest.mark.cuda
def test_ring_keeps_its_slots(card_clf):
    """The ring is made once (at warm-up): the same pinned slots, of
    whole images, serve every request."""
    ring = card_clf._ring
    assert ring is not None and len(ring) == serving.RING_SLOTS
    ptrs = [slot.data_ptr() for slot, _ in ring]
    for seed in (13, 14):
        card_clf.predict(_images(seed))
    assert card_clf._ring is ring
    assert [slot.data_ptr() for slot, _ in card_clf._ring] == ptrs
    for slot, _ in ring:
        assert slot.is_pinned() and slot.dtype == torch.float32
        assert slot.shape == (serving.images_per_chunk(IMAGE), *SHAPE)


@pytest.mark.cuda
def test_counts_what_was_staged(card_clf):
    before = card_clf.staged_chunks, card_clf.staged_bytes
    card_clf.predict(_images(15))  # 111 + 111 + 34
    card_clf.predict(_images(16, n=5))
    card_clf.predict(_pinned(_images(17, n=3)))  # not staged
    assert card_clf.staged_chunks - before[0] == 3 + 1
    assert card_clf.staged_bytes - before[1] == (N + 5) * IMAGE


@pytest.mark.cuda
def test_concurrent_callers_get_their_own_logits(card_clf):
    """More callers than the host has cores, with a short switch interval:
    each gets the logits of its own images."""
    inputs = [_images(20 + t, n=N if t % 2 else 120) for t in range(12)]
    refs = [card_clf.predict(torch.from_numpy(a).to("cuda")).cpu()
            for a in inputs]
    got = [None] * len(inputs)
    errors = []

    def call(t):
        try:
            for _ in range(3):
                got[t] = card_clf.predict(inputs[t]).cpu()
                if not torch.equal(got[t], refs[t]):
                    errors.append(t)
        except Exception as e:  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=call, args=(t,))
                   for t in range(len(inputs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert all(torch.equal(g, r) for g, r in zip(got, refs))
