"""Metrics, logging and tracing.

Counterpart of ``vision_transformers_tpu/utils/metrics.py``:

- ``SmoothedValue`` / ``MetricLogger`` with the windowed median/avg/global
  semantics of the reference's COCO utilities, including the iter/data-time
  split of ``log_every``;
- ``accuracy_topk``;
- ``step_timer``: wall-clock step timing that waits for the CUDA device
  before reading the clock (PyTorch returns before the card finishes);
- ``profile_trace``: a ``torch.profiler`` trace (CPU and, where there is
  one, CUDA activity) written for TensorBoard/Perfetto;
- ``force_sync``: wait for a tensor's device by reading one scalar of it;
- ``get_sha``: the git provenance stamp of the working directory;
- ``span`` / ``take_spans``: the port's named spans (``vtt.serve.*`` in
  ``ServingClassifier.predict``, ``vtt.train.*`` in ``train_step_fn``),
  live only while a ``torch.profiler`` runs.

``SmoothedValue.synchronize_between_processes`` (and ``MetricLogger``'s)
sums (count, total) over the ranks of the process group
(``parallel.distributed.all_reduce_host``); in one process it is the
identity.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _profiler_state
from torch._C._profiler import _RecordFunctionFast


def _multi_process() -> bool:
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1)


class SmoothedValue:
    """Track a series with a smoothing window; exposes median/avg/
    global_avg/max/value like the reference meter."""

    def __init__(self, window_size: int = 20, fmt: Optional[str] = None):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt or "{median:.4f} ({global_avg:.4f})"

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        """(count, total) summed across processes; a no-op in one."""
        if _multi_process():
            from vision_transformers_tpu_torch.parallel.distributed import (
                all_reduce_host,
            )

            count, total = all_reduce_host([self.count, self.total])
            self.count = int(count)
            self.total = float(total)

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class MetricLogger:
    def __init__(self, delimiter: str = "\t"):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{attr}'"
        )

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items()
        )

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def synchronize_between_processes(self):
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = ""):
        """Yield items while logging iter/data time, ETA and meters."""
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)  # type: ignore[arg-type]
        except TypeError:
            total = None
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                if total:
                    eta = datetime.timedelta(
                        seconds=int(iter_time.global_avg * (total - i)))
                    eta_s = f"eta: {eta}"
                else:
                    eta_s = ""
                print(self.delimiter.join(filter(None, [
                    header, f"[{i}" + (f"/{total}]" if total else "]"),
                    eta_s, str(self),
                    f"time: {iter_time}", f"data: {data_time}",
                ])))
            i += 1
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: "
              f"{datetime.timedelta(seconds=int(elapsed))} "
              f"({elapsed / max(i, 1):.4f} s / it)")


def accuracy_topk(logits, labels, topk=(1,)):
    """Top-k accuracies in percent."""
    logits = torch.as_tensor(logits)
    labels = torch.as_tensor(labels)
    maxk = max(topk)
    top = logits.topk(maxk, dim=-1).indices
    correct = top == labels[:, None]
    batch = labels.shape[0]
    return [float(correct[:, :k].sum() * 100.0 / batch) for k in topk]


@contextlib.contextmanager
def step_timer(device=None):
    """Wall-clock timer; on a CUDA ``device`` (or the current one when
    ``device`` is None and CUDA is present) it synchronises before each
    clock read, so the work queued inside is counted."""
    dev = torch.device(device) if device is not None else None
    sync = (torch.cuda.is_available() if dev is None
            else dev.type == "cuda")

    def now():
        if sync:
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    result = {}
    t0 = now()
    yield result
    result["seconds"] = now() - t0


def force_sync(x) -> float:
    """Force device completion by pulling one scalar (the fp32 sum of
    ``x``) to the host."""
    return float(torch.as_tensor(x).float().sum())


@contextlib.contextmanager
def profile_trace(logdir: str):
    """``torch.profiler`` trace of the block (CPU, and CUDA where present),
    written to ``logdir`` as a Chrome/Perfetto trace. The port's spans
    (``span``) are live inside it and show as host operations named
    ``vtt.*`` over the operations they dispatched."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def get_sha() -> str:
    """Git provenance stamp of the working directory: ``"sha: <HEAD>,
    status: clean"`` (or ``has uncommitted changes``), ``"sha: N/A"``
    outside a git checkout."""
    import subprocess

    try:
        sha = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], text=True,
            stderr=subprocess.DEVNULL).strip()
        diff = subprocess.check_output(
            ["git", "diff-index", "HEAD"], text=True,
            stderr=subprocess.DEVNULL).strip()
        return (f"sha: {sha}, status: "
                f"{'has uncommitted changes' if diff else 'clean'}")
    except Exception:
        return "sha: N/A"


SPAN_CAPACITY = 16384  # spans the buffer holds until ``take_spans`` empties it


class SpanRecord(NamedTuple):
    """One closed span: its name, its parent's name (None for a root), the
    ordinal of the request or step it belongs to, and its ends in ns since
    the Unix epoch (``time.time_ns``, the clock of ``torch.profiler``'s
    events: ``trace_start_ns()`` plus an event's relative time)."""

    name: str
    parent: Optional[str]
    ordinal: Optional[int]
    start_ns: int
    end_ns: int


_span_lock = threading.Lock()
_span_buffer: List[SpanRecord] = []
_spans_dropped = 0
_open_spans = threading.local()  # .stack: this thread's open spans
_OFF = contextlib.nullcontext()  # every span while no profiler runs


class _Span:
    """A live span: a profiler range (``_RecordFunctionFast``: a host
    operation in the trace, with no mirror on the device's timeline) and,
    when it closes, one ``SpanRecord`` in the buffer, stamped just inside
    the range."""

    __slots__ = ("name", "ordinal", "parent", "_range", "_start")

    def __init__(self, name: str, ordinal: Optional[int]):
        self.name = name
        self.ordinal = ordinal

    def __enter__(self):
        stack = getattr(_open_spans, "stack", None)
        if stack is None:
            stack = _open_spans.stack = []
        parent = stack[-1] if stack else None
        self.parent = parent.name if parent is not None else None
        if self.ordinal is None and parent is not None:
            self.ordinal = parent.ordinal
        self._range = _RecordFunctionFast(
            self.name, (), {} if self.ordinal is None
            else {"ordinal": self.ordinal})
        self._range.__enter__()
        stack.append(self)
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _open_spans.stack.pop()
        self._range.__exit__(*exc)
        _keep(SpanRecord(self.name, self.parent, self.ordinal, self._start,
                         end))
        return False


def _keep(record: SpanRecord) -> None:
    global _spans_dropped
    with _span_lock:
        if len(_span_buffer) < SPAN_CAPACITY:
            _span_buffer.append(record)
        else:
            _spans_dropped += 1


def span(name: str, ordinal: Optional[int] = None):
    """Context manager naming a phase of the port's work.

    With no profiler running it is one flag read: no profiler range is
    opened and nothing is kept. While a ``torch.profiler`` runs it opens a
    range named ``name`` (nested over the operations it dispatches in the
    trace) and, on exit, keeps a ``SpanRecord`` in a bounded buffer that
    ``take_spans`` empties. ``ordinal`` names the request or step (a root
    span's); a span opened inside another takes its parent's."""
    if not _profiler_state._is_profiler_enabled:
        return _OFF
    return _Span(name, ordinal)


def take_spans() -> Tuple[List[SpanRecord], int]:
    """The spans closed since the last call, in the order they closed, and
    the number dropped because the buffer held ``SPAN_CAPACITY``; empties
    the buffer."""
    global _span_buffer, _spans_dropped
    with _span_lock:
        spans, dropped = _span_buffer, _spans_dropped
        _span_buffer, _spans_dropped = [], 0
    return spans, dropped
