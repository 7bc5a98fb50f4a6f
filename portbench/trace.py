"""The traced part of a run: a few iterations under ``torch.profiler``, and
the reduction of its events to device time, idle time and activity counts.

The iterations are traced twice. The first pass records device activities
alone: the profiler then adds little to the host's work, so the host paces
the card as it does unprofiled, and the busy time, the window and every
device time a metric reads come from it. The window is the span from the
first device activity's start to the last one's end (the traced iterations
end on a synchronisation). One stream, so activities do not overlap; busy
time is still taken as the union of their intervals.

The second pass records the host too, which slows the host's dispatch: it is
read only for what the first cannot say. An idle gap of it is labelled by
what the host was doing at its middle (the benchmark's span and the
innermost host operation running then), and the profiler's own link from
each host operation to the device activities it launched gives, for each of
those, the names of that operation and of the operations around it, so
that a metric can count the device work of one of the program's functions
(the PyTorch work inside an autograd function's backward, say) whatever its
kernels are called.
"""

from __future__ import annotations

import re
from typing import (Callable, Dict, FrozenSet, Iterable, List, Optional,
                    Tuple)

import torch

SPAN = "bench."  # the benchmark's own spans: "bench.window", ...
WINDOW = SPAN + "window"
TOP = 10
LABELLED = 200  # longest gaps labelled and summed by label
# host events of the profiler's own, not of the program
PROFILER_OWN = ("Activity Buffer Request",)

Activity = Tuple[str, float, float]
Launch = Tuple[str, float, FrozenSet[str]]  # name, seconds, host ops around


class Profile:
    """``device``: the device activities (name, start s, end s) of the pass
    with no host events; ``hosted``: those of the pass with host events, and
    ``launched``: the same pass's (name, seconds, names of the host
    operations around its launch) of each device activity that the
    profiler links to a host operation; ``gaps``: that pass's longest idle
    gaps summed by label; ``iters``: the iterations each pass traced."""

    def __init__(self, device: List[Activity], iters: int,
                 gaps: List[Tuple[str, float]],
                 hosted: List[Activity], launched: List[Launch]):
        self.device = device
        self.window_start = min(a[1] for a in device)
        self.window_end = max(a[2] for a in device)
        self.window_s = self.window_end - self.window_start
        self.iters = iters
        self.gaps = gaps
        self.hosted = hosted
        self.launched = launched

    def busy_s(self) -> float:
        return union_s(self.device)

    def seconds_of(self, match: Callable[[str], bool]) -> float:
        return sum(e - s for name, s, e in self.device if match(name))

    def seconds_launched(self, match: Callable[[str], bool],
                         within: Iterable[str]) -> float:
        """Device time, in the pass with host events, of the activities
        whose name ``match`` accepts or that were launched inside a host
        operation named in ``within``; each activity counted once."""
        within = frozenset(within)
        named = sum(e - s for name, s, e in self.hosted if match(name))
        return named + sum(sec for name, sec, around in self.launched
                           if around & within and not match(name))

    def summary(self) -> str:
        """Both passes' device time and window, and the share of the host
        pass's device time that the profiler linked to a host operation."""
        hosted = sum(e - s for _, s, e in self.hosted)
        linked = sum(sec for _, sec, _ in self.launched)
        return (f"device-only pass busy {self.busy_s():.6f} s of "
                f"{self.window_s:.6f} s; host pass device time "
                f"{hosted:.6f} s, linked to host operations {linked:.6f} s")

    def count(self) -> int:
        return len(self.device)

    def top_ops(self) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.device:
            key = name[:120]
            by[key] = by.get(key, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:TOP]


def union_s(activities) -> float:
    """Seconds covered by the union of the activities' intervals."""
    busy, reached = 0.0, float("-inf")
    for _, s, e in sorted(activities, key=lambda a: a[1]):
        s = max(s, reached)
        if e > s:
            busy += e - s
            reached = e
    return busy


def names_matcher(kernels: Iterable[str]) -> Callable[[str], bool]:
    """True for a device activity whose name holds one of ``kernels`` as a
    whole identifier (a demangled name adds template arguments and a
    signature around it)."""
    pat = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(
        re.escape(k) for k in kernels) + r")(?![A-Za-z0-9_])")
    return lambda name: pat.search(name) is not None


def traced(iteration: Callable[[int], None], iters: int) -> Optional[Profile]:
    """Run ``iteration(i)`` for i < ``iters`` under the profiler, once with
    device activities alone and once with host events too, and reduce the
    traces; None when the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            iteration(i)
        torch.cuda.synchronize()
    device_only = list(prof.events())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for i in range(iters):
                iteration(i)
            torch.cuda.synchronize()
    return reduce_events(device_only, list(prof.events()), iters)


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def _span_s(e) -> Tuple[float, float]:
    return e.time_range.start / 1e6, e.time_range.end / 1e6


def _around(op) -> FrozenSet[str]:
    """The names of a host operation and of the operations around it."""
    names = []
    while op is not None:
        names.append(op.name)
        op = getattr(op, "cpu_parent", None)
    return frozenset(names)


def reduce_events(device_only, with_host, iters: int) -> Optional[Profile]:
    # the profiler mirrors the benchmark's spans on the device's timeline;
    # they are not device work
    device = [(e.name, *_span_s(e)) for e in device_only
              if _is_device(e) and not e.name.startswith(SPAN)]
    if not device:
        return None
    window = next(_span_s(e) for e in with_host
                  if not _is_device(e) and e.name == WINDOW)
    inside = lambda s, e: e > window[0] and s < window[1]  # noqa: E731
    host, hosted, launched = [], [], []
    for e in with_host:
        s, t = _span_s(e)
        if _is_device(e):
            if not e.name.startswith(SPAN) and inside(s, t):
                hosted.append((e.name, s, t))
        elif e.name != WINDOW and e.name not in PROFILER_OWN:
            host.append((e.name, s, t))
            kernels = getattr(e, "kernels", ())
            if kernels and inside(s, t):
                around = _around(e)
                # the profiler gives a linked activity's duration in us
                launched += [(k.name, k.duration / 1e6, around)
                             for k in kernels]
    return Profile(device, iters, _gaps(hosted, host, window), hosted,
                   launched)


def _label(t: float, host) -> str:
    """The benchmark's span and the innermost host operation at time t."""
    around = [h for h in host if h[1] <= t <= h[2]]
    if not around:
        return "host idle"
    spans = [h for h in around if h[0].startswith(SPAN)]
    inner = min(around, key=lambda h: h[2] - h[1])[0]
    outer = min(spans, key=lambda h: h[2] - h[1])[0] if spans else ""
    return f"{outer} > {inner}" if outer and outer != inner else inner


def _gaps(device, host, window) -> List[Tuple[str, float]]:
    """The longest spans of the window with no device activity."""
    gaps, end = [], window[0]
    for _, s, e, *_ in sorted(device, key=lambda a: a[1]) + [
            ("", window[1], window[1])]:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled: Dict[str, float] = {}
    for s, e in gaps[:LABELLED]:
        label = _label((s + e) / 2, host)
        labelled[label] = labelled.get(label, 0.0) + (e - s)
    return sorted(labelled.items(), key=lambda kv: -kv[1])[:TOP]
