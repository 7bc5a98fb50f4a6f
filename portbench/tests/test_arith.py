"""The benchmark's arithmetic: MACs, attention work, peaks and the least
time, against published figures, PERF.md's kernel table and chip_smoke.py."""

from __future__ import annotations

import ast
import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from portbench.arith import roofline, swin, vit  # noqa: E402


def _model(config):
    return json.loads((REPO / "portbench" / "configs" /
                       f"{config}.json").read_text())["model"]


def test_macs_per_image():
    # published: 17.6 G (ViT-B/16) and 4.5 G (Swin-T); the copied formulas
    assert vit.macs_per_image(_model("vit_b16_224")) == 17_563_650_048
    assert swin.macs_per_image(_model("swin_t_224")) == 4_489_798_656


@pytest.mark.parametrize("call,train,ms", [
    # PERF.md §6 row 1: B 32, S 197, H 12, dh 64, out and lse: 0.0117 ms
    (dict(pairs=32 * 12, sq=197, sk=197, dh=64, bias_bytes=0,
          dbias_bytes=0, lse=True), True, 0.0117),
    # row 11: Swin-T stage 1, G 2048, N 49, H 3, dh 32, one bias plane:
    # 0.0230 ms
    (dict(pairs=2048 * 3, sq=49, sk=49, dh=32, bias_bytes=3 * 49 * 49 * 4,
          dbias_bytes=0, lse=False), False, 0.0230),
])
def test_attention_work_matches_the_kernel_table(call, train, ms):
    ops, nbytes = roofline.attention_work(call, "fwd", train)
    least, bound = roofline.bound_s(nbytes, ops)
    assert bound == "bytes"
    assert round(least * 1e3, 4) == ms


def test_attention_calls_of_the_cells():
    calls = vit.attention_calls(_model("vit_b16_224"), 256)
    assert len(calls) == 12 and calls[0]["pairs"] == 256 * 12
    calls = swin.attention_calls(_model("swin_t_224"), 128)
    assert [c["pairs"] for c in calls] == (
        [128 * 64 * 3] * 2 + [128 * 16 * 6] * 2 + [128 * 4 * 12] * 6
        + [128 * 24] * 2)
    # shifted blocks carry one bias plane a window; stage 4's window
    # covers its 7 × 7 map, so it never shifts
    assert calls[1]["bias_bytes"] == 64 * 3 * 49 * 49 * 4
    assert calls[0]["bias_bytes"] == 3 * 49 * 49 * 4
    assert calls[11]["bias_bytes"] == 24 * 49 * 49 * 4
    ops_f, _ = roofline.attention_work(calls[0], "fwd", True)
    ops_b, _ = roofline.attention_work(calls[0], "bwd", True)
    assert ops_b == ops_f * 10 // 4


def test_peaks_are_chip_smokes():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    consts = {t.id: ast.literal_eval(node.value) for node in tree.body
              if isinstance(node, ast.Assign) for t in node.targets
              if isinstance(t, ast.Name)
              and t.id in ("HBM_BYTES_PER_S", "PEAK_FLOPS")}
    assert consts["HBM_BYTES_PER_S"] == roofline.HBM_BYTES_PER_S
    assert consts["PEAK_FLOPS"] == roofline.PEAK_FLOPS
    # bound_ms's rule: the larger of bytes and operations
    assert roofline.bound_s(3.35e12, 1.0) == (1.0, "bytes")
    assert roofline.bound_s(1.0, 989e12) == (1.0, "operations")
