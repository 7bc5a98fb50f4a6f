"""The port's spans (``utils.metrics.span``) on the CPU, with tiny models.

- ``ServingClassifier.predict`` and ``train_step_fn``'s step under a CPU
  ``torch.profiler``: the spans' names, nesting and shared ordinals, one
  ``vtt.serve.forward`` a bucket run, ``vtt.train.allreduce`` only under a
  mesh; the buffer's records against the profiler's own ranges (same
  clock, the buffer's just inside), and no mirror of a span among the
  device activities.
- With no profiler running: no profiler range is opened, nothing is kept.
- The buffer's bound and its count of dropped spans.
- Logits, loss and updated weights bit for bit the same with the profiler
  on and off.
"""

import copy
import socket

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vision_transformers_tpu_torch import parallel, serving
from vision_transformers_tpu_torch.models.image_classification import ViT
from vision_transformers_tpu_torch.training import trainer
from vision_transformers_tpu_torch.utils import metrics

SHAPE = (16, 16, 3)
TINY = dict(image_size=16, patch_size=4, num_layers=2, num_heads=2,
            hidden_dim=32, mlp_dim=64, num_classes=4, device="cpu")
TRAIN = ("vtt.train.input", "vtt.train.forward", "vtt.train.backward",
         "vtt.train.optimizer")


@pytest.fixture(autouse=True)
def empty_buffer():
    metrics.take_spans()
    yield
    metrics.take_spans()


@pytest.fixture(scope="module")
def clf(tmp_path_factory):
    torch.manual_seed(0)
    out = str(tmp_path_factory.mktemp("artifact"))
    serving.export_classifier(ViT(**TINY), SHAPE, out, buckets=(2, 4))
    return serving.load_classifier(out, device="cpu")


def _images(n, seed=0):
    return np.random.RandomState(seed).rand(n, *SHAPE).astype(np.float32)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 255, (4, *SHAPE)).astype(np.uint8),
            rng.randint(0, 4, 4), np.ones(4, np.float32))


def _traced(fn):
    """``fn()`` under a CPU profiler: its result, the spans it kept and
    the profiler's events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans, dropped = metrics.take_spans()
    assert dropped == 0
    return out, spans, prof


def _ranges(prof, prefix="vtt."):
    """The profiler's own ranges of the spans, (name, start ns, end ns) on
    the Unix clock, in order of start."""
    zero = prof.profiler.kineto_results.trace_start_ns()
    return sorted(((e.name, zero + int(e.time_range.start * 1e3),
                    zero + int(e.time_range.end * 1e3))
                   for e in prof.events() if e.name.startswith(prefix)),
                  key=lambda r: r[1])


def _check_against_profiler(spans, prof):
    """Every kept span is one of the profiler's host ranges of that name,
    its ends inside the range's (1 ms for the clock's conversion), and the
    profiler put no span on a device's timeline."""
    ranges = _ranges(prof)
    assert [r[0] for r in ranges] == [
        s.name for s in sorted(spans, key=lambda s: s.start_ns)]
    for s, (_, start, end) in zip(sorted(spans, key=lambda s: s.start_ns),
                                  ranges):
        assert start - 1_000_000 <= s.start_ns <= s.end_ns <= end + 1_000_000
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               for e in prof.events() if e.name.startswith("vtt."))


def _inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_predict_spans(clf):
    """One request: predict over input and one forward, all with the
    request's ordinal; a chunked request: a forward a bucket run."""
    first = clf.requests
    _, spans, prof = _traced(lambda: clf.predict(_images(3)))
    assert sorted(s.name for s in spans) == [
        "vtt.serve.forward", "vtt.serve.input", "vtt.serve.predict"]
    root = spans[-1]  # spans close in order: the root last
    assert root.name == "vtt.serve.predict" and root.parent is None
    for s in spans[:-1]:
        assert s.parent == "vtt.serve.predict" and _inside(s, root)
    assert {s.ordinal for s in spans} == {first}
    first_input, first_forward = spans[0], spans[1]
    assert first_input.name == "vtt.serve.input"
    assert first_input.end_ns <= first_forward.start_ns
    _check_against_profiler(spans, prof)
    # a forward range holds the model's operations
    forward = next(r for r in _ranges(prof) if r[0] == "vtt.serve.forward")
    zero = prof.profiler.kineto_results.trace_start_ns()
    assert any(e.name == "aten::linear" and forward[1] <= zero + int(
        e.time_range.start * 1e3) <= forward[2] for e in prof.events())

    _, spans, prof = _traced(lambda: clf.predict(_images(9)))  # 4 + 4 + 1
    names = [s.name for s in spans]
    assert names.count("vtt.serve.forward") == 3
    assert names.count("vtt.serve.input") == names.count(
        "vtt.serve.predict") == 1
    assert {s.ordinal for s in spans} == {first + 1}
    _check_against_profiler(spans, prof)


@pytest.mark.parametrize("steps", [1, 2])
def test_train_step_spans(steps):
    """A step's root holds input, forward, backward and optimizer, one after
    another, all with the state's step before it; no allreduce span without
    a mesh."""
    torch.manual_seed(0)
    model = ViT(**TINY)
    state = trainer.make_train_state(model, lr=1e-3)
    step = trainer.train_step_fn(model)

    def run():
        for i in range(steps):
            step(state, *_batch(i))

    _, spans, prof = _traced(run)
    assert len(spans) == 5 * steps
    for k in range(steps):
        mine = [s for s in spans if s.ordinal == k]
        root = mine[-1]
        assert root.name == "vtt.train.step" and root.parent is None
        assert [s.name for s in mine[:-1]] == list(TRAIN)
        for a, b in zip(mine[:-2], mine[1:-1]):
            assert a.end_ns <= b.start_ns
        assert all(s.parent == "vtt.train.step" and _inside(s, root)
                   for s in mine[:-1])
    assert state.step == steps
    _check_against_profiler(spans, prof)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_train_step_spans_under_a_mesh():
    """At one rank under a mesh the step has its allreduce span, between
    backward and optimizer."""
    parallel.init_distributed_mode(
        coordinator_address=f"localhost:{_free_port()}", num_processes=1,
        process_id=0, device="cpu")
    try:
        torch.manual_seed(0)
        model = ViT(**TINY)
        state = trainer.make_train_state(model, lr=1e-3)
        step = trainer.train_step_fn(
            model, mesh=parallel.make_mesh((1,), ("data",)))
        _, spans, _ = _traced(lambda: step(state, *_batch()))
    finally:
        parallel.destroy_distributed_mode()
    assert [s.name for s in spans] == [
        "vtt.train.input", "vtt.train.forward", "vtt.train.backward",
        "vtt.train.allreduce", "vtt.train.optimizer", "vtt.train.step"]
    assert {s.ordinal for s in spans} == {0}


def test_no_profiler_no_span(clf, monkeypatch):
    """Without a profiler a span opens no profiler range and keeps
    nothing; it is the one shared object."""
    opened = []
    monkeypatch.setattr(metrics, "_RecordFunctionFast",
                        lambda *a: opened.append(a))
    assert metrics.span("vtt.x") is metrics.span("vtt.y", 3)
    clf.predict(_images(9))
    torch.manual_seed(0)
    model = ViT(**TINY)
    trainer.train_step_fn(model)(trainer.make_train_state(model), *_batch())
    assert opened == []
    assert metrics.take_spans() == ([], 0)


def test_buffer_bound(monkeypatch):
    """The buffer keeps SPAN_CAPACITY spans, counts the rest, and is empty
    after it is read."""
    monkeypatch.setattr(metrics, "SPAN_CAPACITY", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        with metrics.span("vtt.root", 7):
            for _ in range(4):
                with metrics.span("vtt.child"):
                    pass
    spans, dropped = metrics.take_spans()
    assert [s.name for s in spans] == ["vtt.child"] * 3
    assert dropped == 2
    assert all(s.ordinal == 7 and s.parent == "vtt.root" for s in spans)
    assert metrics.take_spans() == ([], 0)


def test_same_bits_with_the_profiler_on_and_off(clf):
    """Tracing changes no logit, loss or weight."""
    x = _images(5, seed=3)
    off = clf.predict(x)
    on, _, _ = _traced(lambda: clf.predict(x))
    assert torch.equal(on, off)

    torch.manual_seed(0)
    models = [ViT(**TINY)]
    models.append(copy.deepcopy(models[0]))
    results = []
    for model, traced in zip(models, (False, True)):
        state = trainer.make_train_state(model, lr=1e-3)
        step = trainer.train_step_fn(model)

        def run():
            return [step(state, *_batch(i))[1] for i in range(2)]

        results.append(_traced(run)[0] if traced else run())
    (loss_off, loss_on) = results
    assert all(torch.equal(a, b) for a, b in zip(loss_off, loss_on))
    for (k, a), b in zip(models[0].state_dict().items(),
                         models[1].state_dict().values()):
        assert torch.equal(a, b), k
