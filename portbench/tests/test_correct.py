"""The check decides ``correct`` from the plain reference, and comes out
false when the timed path is broken underneath: a run of a tiny cell on
the CPU (the look for a card skipped), with each fault its cell can have
planted in the program, and the control (the lower precision in the
program's place). The tiny cells carry the real cells' limits."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from portbench import calibrate, harness  # noqa: E402
from tiny import tiny_tree  # noqa: E402

SEED = 3_000_000_029


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return tiny_tree(tmp_path_factory.mktemp("tree"))


def _run(root, cell):
    return harness.run_cell(cell, SEED, 0.3, False, device="cpu", root=root)


@pytest.mark.parametrize("cell", ["tiny_vit.infer", "tiny_swin.infer",
                                  "tiny_vit.train", "tiny_swin.train"])
def test_sound_runs_are_correct(root, cell):
    assert _run(root, cell)["correct"] is True


@pytest.mark.parametrize("cell", ["tiny_vit.infer", "tiny_swin.infer"])
def test_an_answer_altered_where_it_is_produced(root, cell, monkeypatch):
    from vision_transformers_tpu_torch import serving

    predict = serving.ServingClassifier.predict

    def altered(self, images):
        out = predict(self, images).clone()
        out[0] = out[0].flip(0)
        return out

    monkeypatch.setattr(serving.ServingClassifier, "predict", altered)
    assert _run(root, cell)["correct"] is False


@pytest.mark.parametrize("cell", ["tiny_vit.train", "tiny_swin.train"])
def test_a_step_that_leaves_the_state_unchanged(root, cell, monkeypatch):
    from vision_transformers_tpu_torch.training import optimizers

    monkeypatch.setattr(optimizers.Optimizer, "step", lambda self: None)
    result = _run(root, cell)
    assert result["correct"] is False
    assert result["compared"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["tiny_vit.train", "tiny_swin.train"])
def test_half_of_the_batch_left_out(root, cell, monkeypatch):
    from vision_transformers_tpu_torch.training import trainer

    full = trainer.cross_entropy_with_weights

    def half(logits, labels, weights):
        weights = weights.clone()
        weights[weights.shape[0] // 2:] = 0.0
        return full(logits, labels, weights)

    monkeypatch.setattr(trainer, "cross_entropy_with_weights", half)
    assert _run(root, cell)["correct"] is False


@pytest.mark.parametrize("cell", ["tiny_vit.infer", "tiny_swin.infer",
                                  "tiny_vit.train", "tiny_swin.train"])
def test_the_control_is_not_correct(root, cell):
    cell_obj = harness.Cell(cell, root)
    table = calibrate.calibrate(cell, [], [SEED], 0.2, device="cpu",
                                root=root, emit=lambda line: None)
    _, ok = harness.compare({k: v[0] for k, v in table["control"].items()},
                            cell_obj.workload["limits"])
    assert not ok
