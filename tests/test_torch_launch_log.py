"""The kernel libraries' launch logs (csrc/launch_log.cuh), read here from
the sources: every launch site counts the kernel it launched under that
kernel's own name, and every name the route checks of chip_smoke.py and of
the card tests require is one a launch site logs. (The logs themselves run
only on the card.)"""

import re
from pathlib import Path

import pytest

import chip_smoke
from vision_transformers_tpu_torch.ops import _build

CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"
# a launch site names its kernel: vtt::launched("<kernel>"), or
# window_run_launch<D, NK>(<kernel><D, NK>, "<kernel>", ...), whose launch
# lies in window_mma_tile.cuh
_LOGGED = re.compile(r'launched\("(\w+)"\)')
_RUN = re.compile(r'window_run_launch<D, NK>\([\s\\]*(\w+)<D, NK>,[\s\\]*"(\w+)"')


def _logged_names():
    names = set()
    for src in _build.KERNELS:
        text = (CSRC / f"{src}.cu").read_text()
        names |= set(_LOGGED.findall(text))
        names |= {b for _, b in _RUN.findall(text)}
    return names


@pytest.mark.parametrize("src", _build.KERNELS)
def test_every_launch_site_logs_its_kernel(src):
    text = (CSRC / f"{src}.cu").read_text()
    logged = _LOGGED.findall(text)
    runs = _RUN.findall(text)
    # a launch's error is read only through vtt::launched, which logs it
    assert logged or runs
    assert "cudaGetLastError" not in text
    assert all(kernel == name for kernel, name in runs)
    for name in logged + [name for _, name in runs]:
        assert re.search(rf"__global__[^;{{]*\b{name}\(", text), (
            f"{src}.cu logs {name}, a kernel it does not define")


def test_route_names_are_logged_names():
    logged = _logged_names()
    required = {n for names in chip_smoke.ROUTE_NAMES.values() for n in names}
    assert required <= logged, sorted(required - logged)
    helper = (CSRC / "window_mma_tile.cuh").read_text()
    assert helper.count("<<<") == 1 and "return launched(name);" in helper


def test_adam_and_slab_kernels_are_logged_at_their_launch_sites():
    """The multi-tensor Adam kernel (row 15) and the slab window kernel on
    the tensor cores (row 13) log their launches by name; the per-leaf Adam
    kernels they replaced are gone with their launch sites."""
    logged = _logged_names()
    assert {"adam_multi_kernel", "window_fused_slab_mma_kernel"} <= logged
    assert not {"adam_vec_kernel", "adam_scalar_kernel"} & logged
    assert chip_smoke.ROUTE_NAMES[("row 13", "bfloat16")] == (
        "window_fused_slab_mma_kernel",)
