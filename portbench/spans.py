"""The port's spans against the device trace: in which phase of a served
request or a train step the card waits for the host. Not run by the
benchmark's own runs.

    python3 portbench/spans.py --workload <cell> --seed <n> \
        [--iters 4] [--seconds 10]

In one process: the cell's set-up and a window of ``--seconds`` at its
load, unprofiled; then ``--iters`` iterations under ``torch.profiler``
twice, as ``trace.traced`` runs them (device activities alone, then host
events too), keeping each pass's ``trace_start_ns()`` and the port's spans
(``utils.metrics.take_spans``, read after each pass) put on that pass's
clock. A port without spans (an older tree) gives every reading but the
spans'. One JSON line on standard output:

- the device-only pass: device activities, kernel time, busy time, window
  and idle time an iteration, and the host's time an iteration in both
  passes and unprofiled;
- by span name, the host ms and the device-idle ms inside the spans of
  that name an iteration (the idle time inside the union of their
  intervals, clipped to the window), and the idle in the roots' own time
  and outside the roots: together the window's idle time;
- ``readings``: what the per-layer metrics ``input_ms.*``,
  ``fwd_idle_ms.*``, ``bwd_idle_ms.train`` and ``opt_idle_ms.train`` would
  read (each over the number of root spans);
- ``clock``: the host pass's spans as the buffer stamped them against the
  profiler's own ranges of them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

Interval = Tuple[float, float]
# name, parent, ordinal, start s, end s: a span on a pass's clock
PassSpan = Tuple[str, Optional[str], Optional[int], float, float]

ROOTS = {"infer": "vtt.serve.predict", "train": "vtt.train.step"}
# per-layer metric: (span read, host time or device idle)
READINGS = {
    "infer": {"input_ms.infer": ("vtt.serve.input", "host"),
              "fwd_idle_ms.infer": ("vtt.serve.forward", "idle")},
    "train": {"input_ms.train": ("vtt.train.input", "host"),
              "fwd_idle_ms.train": ("vtt.train.forward", "idle"),
              "bwd_idle_ms.train": ("vtt.train.backward", "idle"),
              "opt_idle_ms.train": ("vtt.train.optimizer", "idle")},
}


def on_pass_clock(spans, trace_start_ns: int) -> List[PassSpan]:
    """The port's ``SpanRecord``s in a pass's seconds (the profiler's
    events are relative to the pass's ``trace_start_ns()``)."""
    return [(s.name, s.parent, s.ordinal, (s.start_ns - trace_start_ns) / 1e9,
             (s.end_ns - trace_start_ns) / 1e9) for s in spans]


def merged(intervals) -> List[Interval]:
    """The union of the intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap_s(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """Seconds two unions of disjoint sorted intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_within_s(device, intervals, window: Interval) -> float:
    """Seconds of the union of ``intervals``, clipped to ``window``, in
    which no device activity (name, start s, end s) ran."""
    inside = merged((max(s, window[0]), min(e, window[1]))
                    for s, e in intervals)
    busy = merged((s, e) for _, s, e in device)
    return sum(e - s for s, e in inside) - overlap_s(inside, busy)


def host_s(spans: Sequence[PassSpan], name: str) -> float:
    """Host seconds of the spans named ``name``."""
    return sum(e - s for n, _, _, s, e in spans if n == name)


def idle_in_span_s(device, spans: Sequence[PassSpan], name: str,
                   window: Interval) -> float:
    """Device-idle seconds inside the spans named ``name``."""
    return idle_within_s(device, [(s, e) for n, _, _, s, e in spans
                                  if n == name], window)


def breakdown(device, spans: Sequence[PassSpan], root: str,
              window: Interval) -> Dict[str, Dict[str, float]]:
    """{label: {"host_s", "idle_s"}} over the pass: each child span name,
    ``<root> self`` (a root's time outside its children) and ``outside``
    (the window outside every root). The idle seconds add up to the
    window's idle time where the children of a root do not overlap."""
    out: Dict[str, Dict[str, float]] = {}
    roots = [(s, e) for n, _, _, s, e in spans if n == root]
    for name in sorted({n for n, p, *_ in spans if p == root}):
        out[name] = {"host_s": host_s(spans, name),
                     "idle_s": idle_in_span_s(device, spans, name, window)}
    children = merged((s, e) for _, p, _, s, e in spans if p == root)
    roots_m = merged(roots)
    own = _minus(roots_m, children)
    out[root + " self"] = {"host_s": sum(e - s for s, e in own),
                           "idle_s": idle_within_s(device, own, window)}
    outside = _minus([window], roots_m)
    out["outside"] = {"host_s": sum(e - s for s, e in outside),
                      "idle_s": idle_within_s(device, outside, window)}
    return out


def _minus(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    """The parts of the disjoint sorted intervals ``a`` outside those of
    ``b``."""
    out = []
    for s, e in a:
        cur = s
        for bs, be in b:
            if be <= cur or bs >= e:
                continue
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
        if cur < e:
            out.append((cur, e))
    return out


def readings(kind: str, device, spans: Sequence[PassSpan],
             window: Interval) -> Dict[str, Optional[float]]:
    """The per-layer metrics' values in ms, each over the number of root
    spans; None without a root span."""
    count = sum(1 for n, *_ in spans if n == ROOTS[kind])
    out: Dict[str, Optional[float]] = {}
    for metric, (name, what) in READINGS[kind].items():
        if not count:
            out[metric] = None
            continue
        sec = (host_s(spans, name) if what == "host"
               else idle_in_span_s(device, spans, name, window))
        out[metric] = 1e3 * sec / count
    return out


def clock_check(spans, ranges, within_ns: int = 50_000) -> dict:
    """The buffer's spans against the profiler's ranges of the same names,
    (name, start ns, end ns) on the Unix clock, matched in order of start:
    the largest gap at each end in us and the share of spans within
    ``within_ns`` at both ends."""
    mine = sorted(((s.name, s.start_ns, s.end_ns) for s in spans),
                  key=lambda r: r[1])
    theirs = sorted(ranges, key=lambda r: r[1])
    if [r[0] for r in mine] != [r[0] for r in theirs]:
        return {"matched": False, "spans": len(mine), "ranges": len(theirs)}
    starts = [abs(a[1] - b[1]) for a, b in zip(mine, theirs)]
    ends = [abs(a[2] - b[2]) for a, b in zip(mine, theirs)]
    ok = sum(1 for s, e in zip(starts, ends) if s <= within_ns
             and e <= within_ns)
    return {"matched": True, "spans": len(mine),
            "max_start_us": max(starts, default=0) / 1e3,
            "max_end_us": max(ends, default=0) / 1e3,
            "share_within": ok / max(len(mine), 1)}


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _take_spans():
    """The port's span buffer, emptied; nothing where the port has none."""
    try:
        from vision_transformers_tpu_torch.utils.metrics import take_spans
    except ImportError:
        return [], 0
    return take_spans()


def measure(name: str, seed: int, iters: int, seconds: float,
            device: str = "cuda", root: Path = ROOT) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness, trace

    cell = harness.Cell(name, root)
    dev = torch.device(device)
    ctx = harness.Context(cell, seed, dev)
    loop = cell.traffic.Traffic(ctx)
    loop.setup()
    measured = loop.run(seconds)
    kind = "train" if measured["train"] else "infer"
    out = {"cell": name, "seed": seed, "iters": iters,
           "device": harness.device_info(dev)["kind"],
           "power": harness.power_limit(),
           "unprofiled_ms": 1e3 * measured["window_s"] * measured["batch"]
           / measured["items"]}
    _take_spans()
    passes = []
    for activities in ([ProfilerActivity.CUDA],
                       [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _sync(dev)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for i in range(iters):
                loop.iteration(i)
            _sync(dev)
            wall = time.perf_counter() - t0
        spans, dropped = _take_spans()
        passes.append((list(prof.events()),
                       prof.profiler.kineto_results.trace_start_ns(), spans,
                       dropped, wall))
    (dev_events, start1, spans1, dropped1, wall1), (
        host_events, start2, spans2, dropped2, wall2) = passes
    loop.release()
    # the device activities as the benchmark reads them (``trace``)
    acts = [(e.name, *trace._span_s(e)) for e in dev_events
              if trace._is_device(e) and not e.name.startswith(trace.SPAN)]
    window = (min(a[1] for a in acts), max(a[2] for a in acts))
    busy = trace.union_s(acts)
    kernel = sum(e - s for n, s, e in acts
                 if not n.startswith(("Memcpy", "Memset")))
    out.update({
        "device_pass_ms": 1e3 * wall1 / iters,
        "host_pass_ms": 1e3 * wall2 / iters,
        "launches": len(acts) / iters,
        "kernel_ms": 1e3 * kernel / iters,
        "busy_ms": 1e3 * busy / iters,
        "window_ms": 1e3 * (window[1] - window[0]) / iters,
        "idle_ms": 1e3 * (window[1] - window[0] - busy) / iters,
        "dropped": dropped1 + dropped2,
        "spans": len(spans1)})
    on_clock = on_pass_clock(spans1, start1)
    out["readings"] = readings(kind, acts, on_clock, window)
    if on_clock:
        out["breakdown_ms"] = {
            k: {"host_ms": 1e3 * d["host_s"] / iters,
                "idle_ms": 1e3 * d["idle_s"] / iters}
            for k, d in breakdown(acts, on_clock, ROOTS[kind],
                                  window).items()}
        ranges = [(e.name, start2 + int(e.time_range.start * 1e3),
                   start2 + int(e.time_range.end * 1e3)) for e in host_events
                  if e.name.startswith("vtt.")
                  and not trace._is_device(e)]
        out["clock"] = clock_check(spans2, ranges)
    out["mirrors"] = sum(1 for e in dev_events + host_events
                         if e.name.startswith("vtt.") and trace._is_device(e))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(measure(args.workload, args.seed, args.iters,
                             args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
