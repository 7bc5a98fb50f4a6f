"""The port's distillation losses against the JAX package's, its
checkpoint round trip, DeiT's distillation through ``fit``, and the
numeric-sanitization hooks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.utils import distillation_loss as jdl
from vision_transformers_tpu_torch.models.image_classification import (
    DeiT,
    ViT,
)
from vision_transformers_tpu_torch.training import trainer as ttrainer
from vision_transformers_tpu_torch.utils import checkpoint as tck
from vision_transformers_tpu_torch.utils import debugging as tdbg
from vision_transformers_tpu_torch.utils import distillation_loss as tdl

TINY_DEIT = dict(image_size=16, patch_size=4, num_layers=1, num_heads=2,
                 embed_dim=32, num_classes=10)
TINY_VIT = dict(image_size=16, patch_size=4, num_layers=1, num_heads=2,
                hidden_dim=32, mlp_dim=64, num_classes=10)


def _logits(seed, n=6, c=10):
    return np.random.RandomState(seed).randn(n, c).astype(np.float32) * 3


@pytest.mark.parametrize("tau", [1.0, 5.0])
def test_distillation_losses_match_jax(tau):
    s, t = _logits(1), _logits(2)
    ts, tt = torch.from_numpy(s), torch.from_numpy(t)
    np.testing.assert_allclose(
        tdl.soft_distillation(ts, tt, tau).item(),
        float(jdl.soft_distillation(jnp.asarray(s), jnp.asarray(t), tau)),
        rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        tdl.hard_distillation(ts, tt).item(),
        float(jdl.hard_distillation(jnp.asarray(s), jnp.asarray(t))),
        rtol=1e-5, atol=1e-7)
    for kind in ("none", "soft", "hard"):
        got = tdl.distillation_loss(torch.tensor(0.7), ts, tt, kind, 0.3, tau)
        want = jdl.distillation_loss(jnp.float32(0.7), jnp.asarray(s),
                                     jnp.asarray(t), kind, 0.3, tau)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    with pytest.raises(ValueError, match="Tuple"):
        tdl.distillation_loss(torch.tensor(0.0), None, tt, "hard")


def test_distillation_loss_class_surface():
    s, t = torch.from_numpy(_logits(3)), torch.from_numpy(_logits(4))
    labels = torch.arange(6) % 10
    crit = tdl.DistillationLoss(torch.nn.functional.cross_entropy,
                                lambda x: t, "soft", 0.5, 2.0)
    got = crit(None, (s, s * 0.5), labels)
    want = tdl.distillation_loss(torch.nn.functional.cross_entropy(s, labels),
                                 s * 0.5, t, "soft", 0.5, 2.0)
    assert torch.equal(got, want)
    plain = tdl.DistillationLoss(torch.nn.functional.cross_entropy,
                                 lambda x: t, "none", 0.5, 2.0)
    assert torch.equal(plain(None, s, labels),
                       torch.nn.functional.cross_entropy(s, labels))


def _step(model, seed, opt="adam"):
    state = ttrainer.make_train_state(model, lr=1e-3, optimizer=opt)
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (4, 16, 16, 3)).astype(np.uint8)
    y = rng.randint(0, 10, 4).astype(np.int32)
    state, *_ = ttrainer.train_step_fn(model)(state, x, y,
                                              np.ones(4, np.float32))
    return state


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_checkpoint_round_trip_is_bit_equal(tmp_path, opt):
    """save → keep the newest 2 → restore the latest into a fresh state:
    the model's weights, the optimizer's moments and count, and the step
    are bit-equal; a named step restores that step."""
    model = ViT(**TINY_VIT, device="cpu", seed=1)
    state = _step(model, 0, opt)
    for step in (1, 2, 3):
        tck.save_checkpoint(str(tmp_path), state, step, keep=2)
    assert tck.available_checkpoints(str(tmp_path)) == [2, 3]
    fresh = ttrainer.make_train_state(ViT(**TINY_VIT, device="cpu", seed=2),
                                      lr=1e-3, optimizer=opt)
    got = tck.restore_checkpoint(str(tmp_path), fresh)
    assert got is fresh and got.step == state.step == 1
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              fresh.model.state_dict().items()):
        assert torch.equal(a, b), k
    assert fresh.optimizer.count == state.optimizer.count
    for key, leaves in state.optimizer.state.items():
        assert all(torch.equal(a, b) for a, b in
                   zip(leaves, fresh.optimizer.state[key]))
    tck.restore_checkpoint(str(tmp_path), fresh, step=2)
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(str(tmp_path / "empty"), fresh)


def test_checkpoint_refuses_another_optimizer(tmp_path):
    model = ViT(**TINY_VIT, device="cpu")
    tck.save_checkpoint(str(tmp_path), _step(model, 0, "adam"), 1)
    other = ttrainer.make_train_state(ViT(**TINY_VIT, device="cpu"),
                                      optimizer="sgd")
    with pytest.raises(ValueError, match="optimizer state"):
        tck.restore_checkpoint(str(tmp_path), other)


class _Batches:
    def __init__(self, n, seed):
        rng = np.random.RandomState(seed)
        self.x = rng.randint(0, 256, (n, 4, 16, 16, 3)).astype(np.uint8)
        self.y = rng.randint(0, 10, (n, 4)).astype(np.int32)

    def __iter__(self):
        return iter(zip(self.x, self.y))


@pytest.mark.parametrize("kind", ["hard", "soft"])
def test_deit_distillation_trains_through_fit(kind):
    """``train_model_with_distillation`` with a seeded ViT teacher: the
    loss of the first step is the blend of the class head's CE and the
    distillation term of the distillation head against the teacher, and the
    model gets its ``distilled_training`` setting back."""
    teacher = ViT(**TINY_VIT, device="cpu", seed=3)
    torch.nn.init.normal_(teacher.head.weight)
    model = DeiT(**TINY_DEIT, device="cpu", seed=4)
    for p in (model.head.weight, model.head_dist.weight):
        torch.nn.init.normal_(p, std=0.1)
    data = _Batches(2, 5)
    want = []
    with torch.no_grad():  # lr 0: both steps see the initial weights
        model.distilled_training = True
        model.train()
        for x, y in data:
            x = torch.from_numpy(x).float() / 255.0
            cls, dist = model(x)
            want.append(tdl.distillation_loss(
                torch.nn.functional.cross_entropy(
                    cls, torch.from_numpy(y).long()),
                dist, teacher.eval()(x), kind, 0.5, 3.0).item())
        model.distilled_training = False
    hist = model.train_model_with_distillation(
        data, data, 1, teacher=teacher, distillation_type=kind, alpha=0.5,
        tau=3.0, lr=0.0, verbose=False)
    assert model.distilled_training is False
    np.testing.assert_allclose(hist["train_loss"][0], np.mean(want),
                               rtol=1e-5)


def test_nan_checks_and_checked():
    @tdbg.checked
    def ratio(a, b):
        return {"r": a / b}

    assert ratio(torch.ones(2), torch.ones(2))["r"].tolist() == [1.0, 1.0]
    with pytest.raises(FloatingPointError, match="ratio"):
        ratio(torch.zeros(2), torch.zeros(2))
    x = torch.zeros(2, requires_grad=True)
    with tdbg.nan_checks():
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1).sum().backward()
    tdbg.enable_nan_checks(True)
    assert torch.is_anomaly_enabled()
    tdbg.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
