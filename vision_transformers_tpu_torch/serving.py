"""Export + serving for trained classifiers.

Counterpart of ``vision_transformers_tpu/serving.py``, with its API:
``export_classifier`` → ``load_classifier`` → ``ServingClassifier.predict``
/ ``warmup``, and the ``Microbatcher`` that coalesces concurrent requests.

The JAX package ships StableHLO per batch bucket. PyTorch runs eagerly, so
an artifact here is the model's class name and constructor kwargs in
``manifest.json`` plus its weights (``weights.pt``); the loader rebuilds the
model from this package's registry. Requests are still padded up to a fixed
bucket (or chunked through the largest one), so the card only ever sees the
exported batch sizes.

The registry holds ``ViT``, ``SwinTransformer``, ``SwinTransformerV2``,
``PVT``, ``TwinSVT``, ``DeiT``, ``CPEViT``, ``T2T_ViT``, ``CPVT``,
``CPVTGAP`` and ``TNT``.
Artifacts are for CUDA (``platforms: ["cuda"]``), where the attention runs
through the kernels in ``csrc/``. ``load_classifier(dir, device="cpu")``
serves through the kernels' plain versions, for tests.

``quantize_classifier`` turns a trained ViT into its int8 (w8a8) serving
model (``ops/quant.py``); its artifact carries ``quant8`` in the model kwargs
and the int8 weights in ``weights.pt``.

Data-parallel artifacts (the JAX package's SPMD export): ``export_classifier(
..., mesh=, data_axis=)`` refuses a bucket that the mesh's ``data_axis``
does not divide and records ``nr_devices`` (the mesh's ranks) and
``data_axis`` in the manifest; ``load_classifier(dir, mesh=)`` refuses a
missing mesh or one of another size, and ``predict`` runs each rank's slice
of the bucket and all-gathers the rows, so every rank returns all the
logits. Every rank of the mesh calls these functions together.

On CUDA, ``predict`` copies a request that is in pageable host memory (a
numpy array, a list, an unpinned CPU tensor) to the card through a ring of
``RING_SLOTS`` page-locked slots of up to ``CHUNK_BYTES`` each (a slot holds
at least one image): at most 128 MiB of pinned host memory, or two images
where one is larger, that a loaded classifier holds for its life, made at
``warmup`` or at its first request. Chunk by chunk the host copies (and
casts) images into a free slot and the slot is DMA'd into the request's
device tensor on the current stream, so the host's copy of one chunk
overlaps the DMA of the one before. A lock lets one caller at a time stage
through the ring; the forwards of concurrent callers are not serialised by
it.
"""

from __future__ import annotations

import json
import math
import os
import threading
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vision_transformers_tpu_torch.core.dtypes import (
    DeviceLike,
    DtypeLike,
    as_dtype,
    dtype_name,
    resolve_device,
)
from vision_transformers_tpu_torch.models.image_classification import (
    CPVT,
    CPVTGAP,
    PVT,
    TNT,
    CPEViT,
    DeiT,
    SwinTransformer,
    SwinTransformerV2,
    T2T_ViT,
    TwinSVT,
    ViT,
)
from vision_transformers_tpu_torch.ops.layers import Dense
from vision_transformers_tpu_torch.ops.quant import (
    QuantDense,
    quantize_dense_params,
)
from vision_transformers_tpu_torch.parallel.distributed import is_main_process
from vision_transformers_tpu_torch.parallel.mesh import (
    DataParallel,
    check_mesh,
)
from vision_transformers_tpu_torch.utils.metrics import span

_MANIFEST = "manifest.json"
_WEIGHTS = "weights.pt"
_FORMAT_VERSION = 1
# The pinned ring. The host's copy of a chunk is one parallel region of
# torch's intra-op threads, and on an H100's 8-core host a region now and
# then waits milliseconds for a worker: so few, large chunks. In interleaved
# sweeps of 154 MB requests there, 16 MiB chunks (10 a request) read p95 at
# 2.0-4.6 x their median, 64 MiB (3) at 1.2-2.1 x, with the lowest mean or
# near it; one copy of the whole request gives up the overlap with the DMA.
CHUNK_BYTES = 64 << 20
RING_SLOTS = 2
_MODELS = {"ViT": ViT, "SwinTransformer": SwinTransformer,
           "SwinTransformerV2": SwinTransformerV2, "PVT": PVT,
           "TwinSVT": TwinSVT, "DeiT": DeiT, "CPEViT": CPEViT,
           "T2T_ViT": T2T_ViT, "CPVT": CPVT, "CPVTGAP": CPVTGAP, "TNT": TNT}


def quantize_classifier(model: torch.nn.Module) -> torch.nn.Module:
    """Post-training int8 (w8a8) quantization for serving.

    Returns a new model of ``model``'s class built with ``quant8=True`` on
    its device, loaded with ``model``'s weights: every ``Dense`` that the
    quant8 model builds as a ``QuantDense`` (each encoder block's
    ``self_attention.qkv``, ``self_attention.out``, ``mlp.fc1`` and
    ``mlp.fc2``, the JAX package's targets) becomes int8 per-channel weights
    and fp32 scales (``ops/quant.py``); activations quantize at run time, so
    no calibration set is needed. The patch embedding and the head stay in
    the float dtype. A model without a ``quant8`` serving path raises
    ``ValueError``, as in the JAX package."""
    if not hasattr(model, "quant8"):
        raise ValueError(
            f"{type(model).__name__} has no quant8 serving path")
    device = next(model.parameters()).device
    qmodel = type(model)(**dict(model.config, quant8=True), device=device)
    floats = dict(model.named_modules())
    state = dict(model.state_dict())
    for name, sub in qmodel.named_modules():
        if isinstance(sub, QuantDense) and isinstance(floats[name], Dense):
            del state[f"{name}.weight"]
            state.update({f"{name}.{key}": value for key, value
                          in quantize_dense_params(floats[name]).items()})
    qmodel.load_state_dict(state)
    return qmodel.eval()


def export_classifier(model: torch.nn.Module, input_shape: Sequence[int],
                      out_dir: str, *, buckets: Sequence[int] = (1, 8, 32),
                      dtype: DtypeLike = torch.float32, mesh=None,
                      data_axis: str = "data") -> dict:
    """Write ``model``'s artifact to ``out_dir`` and return the manifest.

    ``input_shape`` is the per-image shape, e.g. ``(224, 224, 3)`` (NHWC);
    ``dtype`` is the INPUT dtype the server will feed (the model's compute
    dtype is whatever it was constructed with, and is in its kwargs).

    With ``mesh`` (``parallel.make_mesh``) the artifact is data-parallel:
    every bucket must divide ``mesh.shape[data_axis]``, and it needs a
    mesh of the same size to load. Rank 0 writes the files; every rank
    returns the manifest once they are written.
    """
    name = type(model).__name__
    if _MODELS.get(name) is not type(model):
        raise ValueError(f"no serving registry entry for {name}; "
                         f"known: {sorted(_MODELS)}")
    buckets = sorted(set(int(b) for b in buckets))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets}")
    if mesh is not None:
        check_mesh(mesh)
        n_shards = mesh.shape[data_axis]
        bad = [b for b in buckets if b % n_shards]
        if bad:
            raise ValueError(f"buckets {bad} not divisible by mesh axis "
                             f"'{data_axis}'={n_shards}")
    manifest = {
        "format_version": _FORMAT_VERSION,
        "platforms": ["cuda"],
        "buckets": buckets,
        "input_shape": [int(d) for d in input_shape],
        "input_dtype": dtype_name(dtype),
        "params_file": _WEIGHTS,
        "model": name,
        "model_kwargs": dict(model.config),
        "torch_version": torch.__version__,
        "nr_devices": 1 if mesh is None else mesh.size,
        "data_axis": None if mesh is None else data_axis,
    }
    if is_main_process():
        os.makedirs(out_dir, exist_ok=True)
        weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        torch.save(weights, os.path.join(out_dir, _WEIGHTS))
        with open(os.path.join(out_dir, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
    if mesh is not None:
        torch.distributed.barrier()
    return manifest


def images_per_chunk(image_bytes: int,
                     chunk_bytes: int = CHUNK_BYTES) -> int:
    """Whole images a staging slot of ``chunk_bytes`` holds; at least one
    (the slot is one image where an image is larger)."""
    return max(1, chunk_bytes // image_bytes)


def staging_chunks(n: int, image_bytes: int,
                   chunk_bytes: int = CHUNK_BYTES) -> List[Tuple[int, int]]:
    """The ``[i, j)`` image ranges in which a request of ``n`` images is
    staged, in order; the last one may be short."""
    per = images_per_chunk(image_bytes, chunk_bytes)
    return [(i, min(i + per, n)) for i in range(0, n, per)]


class ServingClassifier:
    """A loaded artifact: pads/chunks requests through fixed buckets.

    ``predict(images)`` accepts ``(n, *input_shape)`` for any ``n >= 1``
    (or one image without the batch axis): n is padded up to the smallest
    bucket that fits, or chunked through the largest bucket (full chunks run
    un-padded). It returns the logits as a tensor on the model's device, in
    the model's compute dtype.

    On CUDA a request in pageable host memory is staged through the
    classifier's pinned ring (module docstring); ``staged_chunks`` and
    ``staged_bytes`` count the chunks and the bytes (in the input dtype)
    staged so far.
    """

    def __init__(self, manifest: dict, model: torch.nn.Module,
                 device: torch.device, dp=None):
        self.manifest = manifest
        self.model = model
        self.device = device
        self._dp = dp  # data-parallel artifacts: the batch split
        self.buckets = sorted(int(b) for b in manifest["buckets"])
        self.input_shape = tuple(manifest["input_shape"])
        self.input_dtype = as_dtype(manifest["input_dtype"])
        self.requests = 0  # predict calls so far: the next one's ordinal
        self.staged_chunks = 0
        self.staged_bytes = 0
        self._image_bytes = (math.prod(self.input_shape)
                             * self.input_dtype.itemsize)
        self._ring: Optional[list] = None  # [(pinned slot, its last DMA)]
        self._ring_lock = threading.Lock()

    def warmup(self) -> None:
        """Run every bucket once now (kernel builds, library handles) and,
        on CUDA, make the pinned ring, so the first request pays nothing."""
        if self.device.type == "cuda":
            with self._ring_lock:
                self._pinned_ring()
        for b in self.buckets:
            x = torch.zeros((b, *self.input_shape), dtype=self.input_dtype,
                            device=self.device)
            self._run_bucket(b, x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def _run_bucket(self, b: int, x: torch.Tensor) -> torch.Tensor:
        with span("vtt.serve.forward"):
            n = x.shape[0]
            if n < b:
                x = torch.cat([x, x.new_zeros((b - n, *x.shape[1:]))], dim=0)
            if self._dp is not None:
                return self._dp.gather(self.model(self._dp.local(x)))[:n]
            return self.model(x)[:n]

    def _pinned_ring(self) -> list:
        """The ring's slots and, for each, the event of the last DMA that
        read it; made at the first call. Call it under ``_ring_lock``."""
        if self._ring is None:
            per = images_per_chunk(self._image_bytes)
            self._ring = [(torch.empty((per, *self.input_shape),
                                       dtype=self.input_dtype,
                                       pin_memory=True), torch.cuda.Event())
                          for _ in range(RING_SLOTS)]
        return self._ring

    def _stage(self, src: torch.Tensor) -> torch.Tensor:
        """``src``, a CPU tensor ``(n, *input_shape)`` of any dtype and
        strides, on the card in the input dtype: each chunk is copied into
        a slot once the slot's last DMA is done, then DMA'd into the
        request's tensor on the current stream, which orders the forward
        after the last chunk."""
        n = src.shape[0]
        x = torch.empty((n, *self.input_shape), dtype=self.input_dtype,
                        device=self.device)
        stream = torch.cuda.current_stream(self.device)
        chunks = staging_chunks(n, self._image_bytes)
        with self._ring_lock:
            ring = self._pinned_ring()
            for k, (i, j) in enumerate(chunks):
                with span("vtt.serve.stage", k):
                    slot, dma_done = ring[k % len(ring)]
                    dma_done.synchronize()
                    slot[: j - i].copy_(src[i:j])
                    x[i:j].copy_(slot[: j - i], non_blocking=True)
                    dma_done.record(stream)
            self.staged_chunks += len(chunks)
            self.staged_bytes += n * self._image_bytes
        return x

    def _to_device(self, images: Any) -> torch.Tensor:
        """``images`` as ``(n, *input_shape)`` on the device in the input
        dtype. Staged through the pinned ring on CUDA unless already on a
        device or pinned, contiguous and of the input dtype (one DMA)."""
        staged = self.device.type == "cuda" and not (
            isinstance(images, torch.Tensor)
            and (images.device.type != "cpu"
                 or (images.is_pinned() and images.is_contiguous()
                     and images.dtype == self.input_dtype)))
        # staged arrays and tensors are cast chunk by chunk, into the slots
        x = (torch.as_tensor(images)
             if staged and isinstance(images, (np.ndarray, torch.Tensor))
             else torch.as_tensor(images, dtype=self.input_dtype))
        if x.ndim == len(self.input_shape):  # single image convenience
            x = x[None]
        if tuple(x.shape[1:]) != self.input_shape or x.shape[0] < 1:
            raise ValueError(f"expected (n, {self.input_shape}), "
                             f"got {tuple(x.shape)}")
        return self._stage(x) if staged else x.to(self.device)

    def predict(self, images: Any) -> torch.Tensor:
        """Logits for ``images`` of shape ``(n, *input_shape)``. Spans
        (``utils.metrics.span``, ordinal: the call's count):
        ``vtt.serve.predict`` over the call, ``vtt.serve.input`` over the
        conversion, the shape check and the copy to the device, inside it
        ``vtt.serve.stage`` over each chunk staged through the pinned ring
        (ordinal: the chunk's index), and ``vtt.serve.forward`` over each
        bucket run. The ring's lock keeps the staging of concurrent
        callers apart."""
        ordinal = self.requests
        self.requests += 1
        with span("vtt.serve.predict", ordinal):
            with span("vtt.serve.input"):
                x = self._to_device(images)
            n = x.shape[0]
            big = self.buckets[-1]
            if n <= big:
                bucket = next(b for b in self.buckets if b >= n)
                return self._run_bucket(bucket, x)
            parts = [self._run_bucket(big, x[i: i + big])
                     for i in range(0, n, big)]
            return torch.cat(parts, dim=0)


def load_classifier(artifact_dir: str, device: DeviceLike = None,
                    mesh=None) -> ServingClassifier:
    """Load an exported artifact on ``device`` (default CUDA; raises when
    there is no CUDA device unless ``device="cpu"`` is passed). A
    data-parallel artifact needs ``mesh``, of the size it was exported
    for."""
    device = resolve_device(device)
    with open(os.path.join(artifact_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format_version") != _FORMAT_VERSION:
        raise ValueError(
            f"artifact format {manifest.get('format_version')} != "
            f"{_FORMAT_VERSION} supported by this build")
    if device.type == "cuda" and "cuda" not in manifest["platforms"]:
        raise RuntimeError(
            f"artifact exported for {manifest['platforms']} cannot serve on "
            "cuda")
    nr_devices = manifest.get("nr_devices", 1)
    dp = None
    if manifest.get("data_axis") is not None:
        if ((mesh is None and nr_devices > 1) or
                (mesh is not None and check_mesh(mesh).size != nr_devices)):
            raise RuntimeError(
                f"SPMD artifact needs a {nr_devices}-device mesh, got "
                f"{'none' if mesh is None else mesh.size}")
        if mesh is not None:
            dp = DataParallel(mesh, manifest["data_axis"])
    cls = _MODELS.get(manifest["model"])
    if cls is None:
        raise ValueError(f"unknown model {manifest['model']!r}; "
                         f"known: {sorted(_MODELS)}")
    model = cls(**manifest["model_kwargs"], device=device)
    weights = torch.load(os.path.join(artifact_dir, manifest["params_file"]),
                         map_location=device, weights_only=True)
    model.load_state_dict(weights)
    model.eval()
    return ServingClassifier(manifest, model, device, dp)


class Microbatcher:
    """Coalesce concurrent single-image requests into one device call.

    ``submit(image)`` blocks until the result is ready and returns the
    image's logits as an fp32 numpy array; a background flusher fires when
    ``max_batch`` requests are queued or the oldest request has waited
    ``max_wait_ms``. Thread-safe; one device call at a time. An error in a
    device call is raised in every waiter of that batch.
    """

    def __init__(self, classifier: ServingClassifier,
                 max_batch: Optional[int] = None, max_wait_ms: float = 2.0):
        self._clf = classifier
        self._max_batch = max_batch or classifier.buckets[-1]
        self._max_wait = max_wait_ms / 1e3
        self._lock = threading.Condition()
        self._pending: list = []  # [(image, event, slot)]
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, image) -> np.ndarray:
        ev = threading.Event()
        slot: list = [None]
        with self._lock:
            if self._closed:
                raise RuntimeError("Microbatcher is closed")
            self._pending.append((image, ev, slot))
            self._lock.notify()
        ev.wait()
        if isinstance(slot[0], BaseException):
            raise slot[0]
        return slot[0]

    def close(self) -> None:
        """Serve what is queued, then stop the flusher thread."""
        with self._lock:
            self._closed = True
            self._lock.notify()
        self._thread.join()

    def _loop(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._closed:
                    self._lock.wait()
                if not self._pending and self._closed:
                    return
                # batch not full yet: give co-arriving requests a window
                if len(self._pending) < self._max_batch and not self._closed:
                    self._lock.wait(timeout=self._max_wait)
                batch = self._pending[: self._max_batch]
                self._pending = self._pending[self._max_batch:]
            try:
                logits = self._clf.predict(
                    np.stack([np.asarray(b[0]) for b in batch]))
                logits = logits.float().cpu().numpy()
                for i, (_, ev, slot) in enumerate(batch):
                    slot[0] = logits[i]
                    ev.set()
            except Exception as e:  # surface to every waiter of the batch
                for _, ev, slot in batch:
                    slot[0] = e
                    ev.set()
