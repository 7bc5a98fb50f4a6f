"""The port's spans against a device trace, on events made up here: the
spans put on a pass's clock, host time and device idle by span, the
decomposition of a pass's idle time, the clock check; and the port's spans
in a host pass (host operations, no device mirror) leave every reading of
``trace`` as it was."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from portbench import spans as S  # noqa: E402
from portbench import trace  # noqa: E402
from test_trace import CUDA, device_only, ev, with_host  # noqa: E402

ZERO = 1_700_000_000_000_000_000  # a pass's trace_start_ns()


def rec(name, parent, ordinal, start_us, end_us):
    """A SpanRecord as the port keeps it, times in us after ZERO."""
    return SimpleNamespace(name=name, parent=parent, ordinal=ordinal,
                           start_ns=ZERO + start_us * 1000,
                           end_ns=ZERO + end_us * 1000)


# two train steps; device busy 100-400 (copy), 450-700, 800-900 in step 0,
# and 1100-1300 in step 1
DEVICE = [("Memcpy HtoD", 100e-6, 400e-6), ("k", 450e-6, 700e-6),
          ("adam", 800e-6, 900e-6), ("k", 1100e-6, 1300e-6)]
WINDOW = (100e-6, 1300e-6)


def two_steps():
    out = []
    for k, base in ((0, 0), (1, 1000)):
        out += [rec("vtt.train.input", "vtt.train.step", k, base + 50,
                    base + 420),
                rec("vtt.train.forward", "vtt.train.step", k, base + 420,
                    base + 600),
                rec("vtt.train.backward", "vtt.train.step", k, base + 600,
                    base + 780),
                rec("vtt.train.optimizer", "vtt.train.step", k, base + 780,
                    base + 850),
                rec("vtt.train.step", None, k, base + 40, base + 870)]
    return out


def test_on_pass_clock():
    got = S.on_pass_clock([rec("vtt.a", None, 3, 10, 25)], ZERO)
    assert got == [("vtt.a", None, 3, pytest.approx(10e-6),
                    pytest.approx(25e-6))]


def test_interval_helpers():
    assert S.merged([(3, 4), (0, 1), (0.5, 2), (5, 5)]) == [(0, 2), (3, 4)]
    assert S.overlap_s([(0, 2), (3, 4)], [(1, 3.5)]) == pytest.approx(1.5)
    assert S._minus([(0, 10)], [(2, 3), (5, 12)]) == [(0, 2), (3, 5)]
    # idle inside [0, 10] clipped to [1, 9] with busy 2-3 and 8-12
    acts = [("a", 2, 3), ("b", 8, 12)]
    assert S.idle_within_s(acts, [(0, 10)], (1, 9)) == pytest.approx(6)


def test_host_and_idle_by_span():
    spans = S.on_pass_clock(two_steps(), ZERO)
    assert S.host_s(spans, "vtt.train.input") == pytest.approx(740e-6)
    # step 0 forward 420-600: idle 420-450; step 1 1420-1600: all idle
    # but the window ends at 1300, so nothing of it counts
    assert S.idle_in_span_s(DEVICE, spans, "vtt.train.forward",
                            WINDOW) == pytest.approx(30e-6)
    # backward 600-780 (busy to 700) and 1600-1780 (outside the window)
    assert S.idle_in_span_s(DEVICE, spans, "vtt.train.backward",
                            WINDOW) == pytest.approx(80e-6)
    got = S.readings("train", DEVICE, spans, WINDOW)
    assert got == {"input_ms.train": pytest.approx(0.37),
                   "fwd_idle_ms.train": pytest.approx(0.015),
                   "bwd_idle_ms.train": pytest.approx(0.04),
                   "opt_idle_ms.train": pytest.approx(0.01)}


def test_readings_without_a_root_are_none():
    assert S.readings("infer", DEVICE, [], WINDOW) == {
        "input_ms.infer": None, "fwd_idle_ms.infer": None}


def test_idle_adds_up_to_the_windows():
    """Idle inside each child, plus in the roots' own time, plus outside
    the roots, is the window's idle time."""
    spans = S.on_pass_clock(two_steps(), ZERO)
    parts = S.breakdown(DEVICE, spans, "vtt.train.step", WINDOW)
    assert set(parts) == {"vtt.train.input", "vtt.train.forward",
                          "vtt.train.backward", "vtt.train.optimizer",
                          "vtt.train.step self", "outside"}
    idle = (WINDOW[1] - WINDOW[0]) - trace.union_s(DEVICE)
    assert sum(p["idle_s"] for p in parts.values()) == pytest.approx(idle)
    # step 0 runs 40-870 and step 1 1040-1870: outside 870-1040 in the
    # window, busy to 900
    assert parts["outside"]["host_s"] == pytest.approx(170e-6)
    assert parts["outside"]["idle_s"] == pytest.approx(140e-6)
    # the roots' own time: 40-50 before the window, 850-870 busy,
    # 1040-1050 idle, 1850-1870 past the window
    assert parts["vtt.train.step self"]["idle_s"] == pytest.approx(10e-6)


def test_clock_check():
    spans = [rec("vtt.b", "vtt.a", 0, 20, 30), rec("vtt.a", None, 0, 10, 40)]
    ranges = [("vtt.a", ZERO + 9_990, ZERO + 40_030),
              ("vtt.b", ZERO + 19_900, ZERO + 30_000)]
    got = S.clock_check(spans, ranges)
    assert got["matched"] and got["spans"] == 2
    assert got["max_start_us"] == pytest.approx(0.1)
    assert got["max_end_us"] == pytest.approx(0.03)
    assert got["share_within"] == 1.0
    assert S.clock_check(spans, ranges, within_ns=50)["share_within"] == 0.5
    assert not S.clock_check(spans, ranges[:1])["matched"]


def test_port_spans_as_host_operations_change_no_reading():
    """The port's spans are host ranges with no device mirror: added to a
    host pass, every reading of ``trace`` is the same, and the gaps sum to
    the same idle time (a gap's label may name the span)."""
    plain = trace.reduce_events(device_only(), with_host(), iters=2)
    spanned = with_host() + [ev("vtt.serve.predict", 10, 690),
                             ev("vtt.serve.input", 20, 320)]
    got = trace.reduce_events(device_only(), spanned, iters=2)
    assert (got.busy_s(), got.window_s, got.count(), got.top_ops()) == (
        plain.busy_s(), plain.window_s, plain.count(), plain.top_ops())
    for match, within in ((trace.names_matcher(["window_bwd_mma_kernel"]),
                           ["_WindowAttentionBackward"]),
                          (lambda n: False, ["bench.predict"])):
        assert got.seconds_launched(match, within) == pytest.approx(
            plain.seconds_launched(match, within))
    assert sum(s for _, s in got.gaps) == pytest.approx(
        sum(s for _, s in plain.gaps))
    assert all(e.device_type != CUDA for e in spanned
               if e.name.startswith("vtt."))
