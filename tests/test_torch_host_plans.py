"""The host-side plans of two CUDA kernels, compiled from their headers with
the system's C++ compiler and run on the CPU: the same code the C entries
run on the card's host.

- ``csrc/adam_plan.cuh``: how the multi-tensor Adam launch packs the leaves
  of a step into tables of one launch each, and which elements of which
  leaf each chunk of a launch updates. Every element of every leaf must be
  taken exactly once.
- ``csrc/window_run_plan.cuh``: the run a window block walks and, for the
  slab kernel (row 13), the windows of one window row a block owns. Every
  window must be taken exactly once, and no block may cross a window row.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from vision_transformers_tpu_torch.ops import _build
from vision_transformers_tpu_torch.ops import fused_adam as tadam

_L = ctypes.c_longlong
_I = ctypes.c_int
_PL = ctypes.POINTER(_L)
_PI = ctypes.POINTER(_I)

# extern "C" wrappers of the headers' functions
_SHIM = r"""
#include "adam_plan.cuh"
#include "window_run_plan.cuh"

static vtt::adam::Table table;

extern "C" {
int adam_max_leaves() { return vtt::adam::kMaxLeaves; }
int adam_chunk_elems() { return vtt::adam::kChunk; }
int adam_pack(const long long* leaves, int total, int first, int* chunks,
              int* aligned) {
  const int count = vtt::adam::pack(leaves, total, first, &table);
  *chunks = count ? table.first_chunk[count] : 0;
  for (int l = 0; l < count; ++l) aligned[l] = table.aligned[l];
  return count;
}
int adam_chunk(int c, long long* begin, long long* end) {
  const vtt::adam::Chunk ch = vtt::adam::chunk_of(table, c);
  *begin = ch.begin;
  *end = ch.end;
  return ch.leaf;
}
int max_run() { return vtt::mma::kMaxRun; }
int run_plan(long long g, int row_windows, int wpb, int heads, long long wave,
             long long* blocks) {
  const vtt::mma::RunPlan p =
      vtt::mma::window_run_plan(g, row_windows, wpb, heads, wave);
  *blocks = p.blocks;
  return p.run;
}
int row_block(int x, int row_windows, int wpb, int run, long long* first,
              long long* end) {
  const vtt::mma::RowBlock b = vtt::mma::row_block(x, row_windows, wpb, run);
  *first = b.first;
  *end = b.end;
  return b.row;
}
}
"""


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler (g++ or c++)")
    tmp = tmp_path_factory.mktemp("host_plans")
    (tmp / "shim.cpp").write_text(_SHIM)
    lib = tmp / "libplans.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(_build.CSRC), "-o", str(lib),
                    str(tmp / "shim.cpp")], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    so.adam_pack.argtypes = [_PL, _I, _I, _PI, _PI]
    so.adam_chunk.argtypes = [_I, _PL, _PL]
    so.run_plan.argtypes = [_L, _I, _I, _I, _L, _PL]
    so.row_block.argtypes = [_I, _I, _I, _I, _PL, _PL]
    return so


def _adam_launches(so, sizes, misaligned=()):
    """Walks every chunk of every launch of a step over leaves of ``sizes``
    (fake pointers, 16-byte aligned but for the leaves in ``misaligned``):
    how often each element was taken, the leaves of each launch, and the
    aligned flags the tables hold."""
    table = np.zeros((len(sizes), 5), np.int64)
    for i, n in enumerate(sizes):
        base = (i + 1) << 32
        table[i, :4] = [base, base + 0x1000, base + 0x2000, base + 0x3000]
        if i in misaligned:
            table[i, 3] += 4  # g only: one pointer is enough
        table[i, 4] = n
    taken = [np.zeros(n, np.int32) for n in sizes]
    launches, flags = [], []
    chunks, begin, end = _I(), _L(), _L()
    aligned = (_I * so.adam_max_leaves())()
    first = 0
    ptr = table.ctypes.data_as(_PL)
    while first < len(sizes):
        count = so.adam_pack(ptr, len(sizes), first, ctypes.byref(chunks),
                             aligned)
        assert 1 <= count <= so.adam_max_leaves()
        for c in range(chunks.value):
            leaf = so.adam_chunk(c, ctypes.byref(begin), ctypes.byref(end))
            assert 0 <= leaf < count
            assert 0 <= begin.value < end.value <= sizes[first + leaf]
            assert end.value - begin.value <= so.adam_chunk_elems()
            taken[first + leaf][begin.value:end.value] += 1
        launches.append(count)
        flags += list(aligned[:count])
        first += count
    return taken, launches, flags


@pytest.mark.parametrize("sizes", [
    [1], [3], [65535], [65536], [65539],
    [1, 3, 65535, 65536, 65539, 768 * 3072 // 64, 2049, 2048, 2047],
])
def test_adam_plan_takes_every_element_once(plans, sizes):
    taken, launches, flags = _adam_launches(plans, sizes, misaligned={0})
    assert launches == [len(sizes)]  # one launch a step
    assert all((t == 1).all() for t in taken)
    assert flags == [0] + [1] * (len(sizes) - 1)


def test_adam_plan_past_one_table(plans):
    """More leaves than a launch's table holds: launches of full tables in
    order, the rest in the last, every element still taken once."""
    assert tadam._TABLE_LEAVES == plans.adam_max_leaves()
    rng = np.random.RandomState(3)
    sizes = [int(n) for n in rng.choice([1, 3, 7, 96, 768, 2048, 2049, 65539],
                                        size=2 * tadam._TABLE_LEAVES + 17)]
    taken, launches, _ = _adam_launches(plans, sizes)
    m = tadam._TABLE_LEAVES
    assert launches == [m, m, 17]
    assert -(-len(sizes) // m) == len(launches)
    assert all((t == 1).all() for t in taken)


def test_adam_plan_refuses_an_empty_leaf(plans):
    table = np.zeros((2, 5), np.int64)
    table[:, 4] = [0, 5]
    chunks = _I()
    aligned = (_I * plans.adam_max_leaves())()
    assert plans.adam_pack(table.ctypes.data_as(_PL), 2, 0,
                           ctypes.byref(chunks), aligned) == 0
    assert plans.adam_pack(table.ctypes.data_as(_PL), 2, 1,
                           ctypes.byref(chunks), aligned) == 1


def _slab_blocks(so, rows, nw, wpb, heads, wave):
    """Walks every block of a row-constrained launch as the slab kernel
    does (window_run_mma: slot w takes first + w + s·wpb below end): how
    often each window was taken, and the plan's run."""
    blocks, first, end = _L(), _L(), _L()
    run = so.run_plan(rows * nw, nw, wpb, heads, wave, ctypes.byref(blocks))
    taken = np.zeros(rows * nw, np.int32)
    for x in range(blocks.value):
        row = so.row_block(x, nw, wpb, run, ctypes.byref(first),
                           ctypes.byref(end))
        assert end.value == (row + 1) * nw  # the row's end
        assert row * nw <= first.value < end.value  # inside the row
        for w in range(wpb):
            for s in range(run):
                gw = first.value + w + s * wpb
                if gw < end.value:
                    taken[gw] += 1
    return taken, run, blocks.value


@pytest.mark.parametrize("rows", [1, 2, 8, 256])
@pytest.mark.parametrize("nw", [1, 5, 6, 7, 8, 16])
@pytest.mark.parametrize("wpb", [1, 2, 4])
def test_slab_runs_never_cross_a_window_row(plans, rows, nw, wpb):
    row_steps = -(-nw // wpb)
    for heads, wave in ((3, 528), (1, 132), (24, 1056), (3, 1)):
        taken, run, blocks = _slab_blocks(plans, rows, nw, wpb, heads, wave)
        assert (taken == 1).all()
        assert 1 <= run <= plans.max_run() and row_steps % run == 0
        assert blocks == rows * (row_steps // run)


def test_slab_run_at_swin_t_stage_1(plans):
    """B 32 × nr 8 window rows of nw 8 windows of N 49 (one a step), H 3,
    on a card holding 132 × 4 blocks: whole rows would take two waves of 8
    steps; runs of 4 take 3 waves of 4 steps, the fewest steps (runs of 1
    and 2 tie at 12 and walk shorter runs). At bucket 1 every window is a
    block of its own: one wave."""
    assert _slab_blocks(plans, 256, 8, 1, 3, 528)[1:] == (4, 512)
    assert _slab_blocks(plans, 8, 8, 1, 3, 528)[1:] == (1, 64)


@pytest.mark.parametrize("g,wpb,heads,wave", [
    (2048, 1, 3, 528), (2048, 1, 3, 132 * 6), (32, 1, 24, 528),
    (1, 4, 3, 528), (10 ** 6, 2, 1, 132), (1568, 1, 3, 1)])
def test_flat_runs_take_every_window_once(plans, g, wpb, heads, wave):
    """Rows 11 and 12 (no row constraint): block x walks from window
    x · wpb · run on, as their kernels start it, and at most kMaxRun steps;
    one wave of blocks where kMaxRun steps a block allow it."""
    blocks = _L()
    run = plans.run_plan(g, 0, wpb, heads, wave, ctypes.byref(blocks))
    assert 1 <= run <= plans.max_run()
    taken = np.zeros(g, np.int32)
    for x in range(blocks.value):
        for w in range(wpb):
            for s in range(run):
                gw = x * wpb * run + w + s * wpb
                if gw < g:
                    taken[gw] += 1
    assert (taken == 1).all()
    steps = -(-g // wpb)
    if steps <= max(1, wave // heads) * plans.max_run():
        assert blocks.value * heads <= max(wave, heads)
