"""The SwinV2 family of the benchmark: a tiny SwinV2 configuration and train
cell written as new files into ``tiny_tree``'s copy, run on the CPU against
the real cell's limits (a sound run is correct, a half-batch fault, an
unchanged state and the float8 control are not), the reference's leaves
against the port's state dict, and the arithmetic of the real
configuration."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from portbench import calibrate, harness  # noqa: E402
from portbench.arith import swinv2 as arith  # noqa: E402
from portbench.reference import swinv2 as ref  # noqa: E402
from tiny import tiny_tree  # noqa: E402

SEED = 3_000_000_037
REAL = "swinv2_b_w16_256"
CELL = "tiny_swinv2.train"
# maps 24, 12, 6 at window 12: stages 1 and 2 attend 144-token windows
# (the split-head path), stage 3 is clipped to its 6 × 6 map
TINY = {"family": "swinv2", "port_class": "SwinTransformerV2",
        "dtype": "float32",
        "model": {"image_size": 48, "patch_size": [2, 2], "embed_dim": 16,
                  "depths": [2, 2, 2], "num_heads": [1, 2, 4],
                  "window_size": [12, 12], "mlp_ratio": 4.0, "dropout": 0.0,
                  "attention_dropout": 0.0, "stochastic_depth_prob": 0.3,
                  "num_classes": 10, "clip_window": True}}


def _real():
    return json.loads((REPO / "portbench" / "configs" /
                       f"{REAL}.json").read_text())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """``tiny_tree``'s copy with the tiny SwinV2 configuration and a train
    cell at batch 8 that takes the real cell's control and limits."""
    torch.set_num_threads(4)
    dest = tiny_tree(tmp_path_factory.mktemp("tree"))
    bench = dest / "portbench"
    real = json.loads((bench / "workloads" /
                       f"{REAL}.train_b128.json").read_text())
    (bench / "configs" / "tiny_swinv2.json").write_text(json.dumps(TINY))
    (bench / "workloads" / f"{CELL}.json").write_text(json.dumps(
        dict(real, config="tiny_swinv2",
             params=dict(real["params"], batch=8, distinct=4))))
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": CELL, "config": "tiny_swinv2",
                              "traffic": "train_steps", "chips": 1,
                              "why": "a CPU test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if f"{REAL}.train_b128" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


def _run(root):
    return harness.run_cell(CELL, SEED, 0.3, False, device="cpu", root=root)


def test_a_sound_run_is_correct(root):
    result = _run(root)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"train_img_per_s", "setup_s"}


def test_a_step_that_leaves_the_state_unchanged(root, monkeypatch):
    from vision_transformers_tpu_torch.training import optimizers

    monkeypatch.setattr(optimizers.Optimizer, "step", lambda self: None)
    result = _run(root)
    assert result["correct"] is False
    assert result["compared"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(root, monkeypatch):
    from vision_transformers_tpu_torch.training import trainer

    full = trainer.cross_entropy_with_weights

    def half(logits, labels, weights):
        weights = weights.clone()
        weights[weights.shape[0] // 2:] = 0.0
        return full(logits, labels, weights)

    monkeypatch.setattr(trainer, "cross_entropy_with_weights", half)
    assert _run(root)["correct"] is False


def test_the_control_is_not_correct(root):
    cell = harness.Cell(CELL, root)
    table = calibrate.calibrate(CELL, [], [SEED], 0.2, device="cpu",
                                root=root, emit=lambda line: None)
    _, ok = harness.compare({k: v[0] for k, v in table["control"].items()},
                            cell.workload["limits"])
    assert not ok


@pytest.mark.parametrize("model", [TINY["model"], _real()["model"]],
                         ids=["tiny", "real"])
def test_param_spec_is_the_port_state_dict(model):
    """Every leaf of the port's model under the same name and shape."""
    from vision_transformers_tpu_torch.models.image_classification import (
        SwinTransformerV2,
    )

    port = SwinTransformerV2(**model, device="cpu")
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {n: tuple(s) for n, s, _, _ in ref.param_spec(model)} == want


def test_macs_of_the_real_configuration():
    """Within 5% of the paper's 21.8 G for SwinV2-B @256 w16
    (arXiv:2111.09883, Table 2), and about 88 M leaves' elements."""
    m = _real()["model"]
    assert abs(arith.macs_per_image(m) / 21.8e9 - 1.0) < 0.05
    params = sum(torch.Size(s).numel() for _, s, _, _ in ref.param_spec(m))
    assert abs(params / 88e6 - 1.0) < 0.05


def test_attention_calls_of_the_real_configuration():
    """22 split-head calls at N 256 (stages 1-3), the shifted ones with a
    plane a window; 2 batched window calls at stage 4's 8 × 8."""
    m = _real()["model"]
    calls = arith.attention_calls(m, 128)
    split = [c for c in calls if c["lse"]]
    assert len(split) == 22 and len(calls) == 24
    assert {(c["sq"], c["dh"]) for c in split} == {(256, 32)}
    assert [c["pairs"] for c in split] == (
        [128 * 16 * 4] * 2 + [128 * 4 * 8] * 2 + [128 * 16] * 18)
    assert split[1]["bias_bytes"] == 16 * 4 * 256 ** 2 * 4   # shifted
    assert split[0]["bias_bytes"] == 4 * 256 ** 2 * 4
    assert split[3]["bias_bytes"] == 4 * 8 * 256 ** 2 * 4    # stage 2
    assert split[5]["bias_bytes"] == 16 * 256 ** 2 * 4       # covers its map
    batched = calls[22:]
    assert [(c["pairs"], c["sq"], c["lse"]) for c in batched] == [
        (128 * 32, 64, False)] * 2
