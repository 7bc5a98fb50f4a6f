"""The reduction of a profiler trace, on events made up here: busy time,
the window, device activities, what launched them, idle gaps and their
labels."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import trace  # noqa: E402

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, start_us, end_us, device=CPU, parent=None, kernels=()):
    """An event as ``torch.profiler`` gives it; ``kernels``: the device
    activities (name, start us, end us) that a host operation launched."""
    return SimpleNamespace(
        name=name, device_type=device, cpu_parent=parent,
        kernels=[SimpleNamespace(name=k, device=0, duration=e - s)
                 for k, s, e in kernels],
        time_range=SimpleNamespace(start=start_us, end=end_us))


def device_only():
    return [
        ev("Memcpy HtoD (Pageable -> Device)", 100, 400, CUDA),
        ev("void packed_fwd_mma_kernel<64, false>(int)", 400, 500, CUDA),
        ev("void packed_fwd_mma_kernel<64, false>(int)", 450, 550, CUDA),
        ev("gemm", 800, 900, CUDA),
    ]


def with_host():
    bwd = "void window_bwd_mma_kernel<32>(int)"
    predict = ev("bench.predict", 0, 700, kernels=[("gemm", 1800, 1900)])
    function = ev("_WindowAttentionBackward", 320, 690, parent=predict,
                  kernels=[(bwd, 400, 500)])
    total = ev("aten::sum", 330, 340, parent=function,
               kernels=[("reduce_kernel<float>", 500, 650)])
    return [
        ev("bench.window", 0, 2000),
        predict,
        ev("aten::copy_", 50, 300, parent=predict,
           kernels=[("Memcpy HtoD (Pageable -> Device)", 100, 400)]),
        ev("Activity Buffer Request", 100, 120),
        function,
        total,
        ev("bench.predict", 0, 600, CUDA),          # a span's mirror
        ev("Memcpy HtoD (Pageable -> Device)", 100, 400, CUDA),
        ev(bwd, 400, 500, CUDA),
        ev("reduce_kernel<float>", 500, 650, CUDA),
        ev("gemm", 1800, 1900, CUDA),
        ev("gemm", 2200, 2300, CUDA),                # after the window
    ]


def test_reduce_events():
    p = trace.reduce_events(device_only(), with_host(), iters=2)
    assert p.window_s == pytest.approx(800e-6)      # 100 to 900
    assert p.count() == 4
    assert p.busy_s() == pytest.approx(550e-6)      # 100-550 and 800-900
    match = trace.names_matcher(["packed_fwd_mma_kernel"])
    assert p.seconds_of(match) == pytest.approx(200e-6)
    assert not trace.names_matcher(["packed_fwd"])(device_only()[1].name)
    assert p.seconds_of(lambda n: "HtoD" in n) == pytest.approx(300e-6)
    assert p.top_ops()[0] == ["Memcpy HtoD (Pageable -> Device)",
                              pytest.approx(300e-6)]
    window_bwd = trace.names_matcher(["window_bwd_mma_kernel"])
    assert p.seconds_launched(window_bwd, ()) == pytest.approx(100e-6)
    # the sum launched inside the function's backward counts, the kernel
    # once; the copy launched beside it does not
    assert p.seconds_launched(window_bwd, ["_WindowAttentionBackward"]) == (
        pytest.approx(250e-6))
    assert p.seconds_launched(window_bwd, ["aten::sum"]) == (
        pytest.approx(250e-6))
    assert p.seconds_launched(lambda n: False, ["aten::copy_"]) == (
        pytest.approx(300e-6))
    assert p.seconds_launched(lambda n: False, ["bench.predict"]) == (
        pytest.approx(650e-6))
    gaps = dict(p.gaps)
    assert gaps["bench.predict > aten::copy_"] == pytest.approx(100e-6)
    assert gaps["host idle"] == pytest.approx(1250e-6)  # 650-1800, 1900-2000


def test_no_device_activity_gives_nothing():
    assert trace.reduce_events([], [ev("bench.window", 0, 10)], 1) is None
