"""The tail of the port against the JAX package on the CPU:
``utils/optimization.py`` (``run_study``, ``Trial``, ``objective``),
``utils/visualization.py`` (``plot_patches``, ``plot_attention_maps``) and
the public names ``core.Policy`` / ``core.default_policy``,
``utils.metrics.force_sync`` / ``get_sha`` and the re-exports of
``utils.coco.util.misc``.

The search: the same seed and a pure-Python objective give the same trial
parameters, reports, prunings, values and ``best_value`` in both packages
(exactly: both draw from numpy's ``RandomState``). The figures: the same
arrays give the same pixels and heatmap values (exactly: the same numpy
arithmetic and matplotlib calls; the port takes torch tensors too).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_data import SyntheticLoader
from vision_transformers_tpu import core as jcore
from vision_transformers_tpu.utils import metrics as jmetrics
from vision_transformers_tpu.utils import optimization as jopt
from vision_transformers_tpu.utils import visualization as jviz
from vision_transformers_tpu_torch import core
from vision_transformers_tpu_torch.models.image_classification import ViT
from vision_transformers_tpu_torch.utils import metrics
from vision_transformers_tpu_torch.utils import optimization as opt
from vision_transformers_tpu_torch.utils import visualization as viz
from vision_transformers_tpu_torch.utils.coco.util import misc


def _search(trial, pruned):
    """A pure-Python objective over the whole search space, with reports
    that prune."""
    n = trial.suggest_int("num_layers", *opt.SEARCH_SPACE["num_layers"])
    mlp = trial.suggest_categorical("mlp_dim", opt.SEARCH_SPACE["mlp_dim"])
    lr = trial.suggest_float("lr", 1e-5, 1e-2, log=True)
    drop = trial.suggest_float("dropout", 0.0, 0.3)
    name = trial.suggest_categorical("optimizer",
                                     opt.SEARCH_SPACE["optimizer"])
    value = -abs(np.log10(lr) + 3) - drop + n / 8 + mlp / 1024 + len(name)
    for step in range(3):
        trial.report(value + step, step)
        if trial.should_prune():
            raise pruned()
    return value


def test_run_study_matches_jax():
    want = jopt.run_study(lambda t: _search(t, jopt.TrialPruned), 9, seed=3)
    got = opt.run_study(lambda t: _search(t, opt.TrialPruned), 9, seed=3)
    assert got.values == want.values
    assert [t.params for t in got.trials] == [t.params for t in want.trials]
    assert [t.reports for t in got.trials] == [t.reports for t in want.trials]
    assert got.best_value == want.best_value
    assert got.best_trial.params == want.best_trial.params
    assert None in got.values  # pruning took some


def test_objective_matches_jax_suggestions_and_carries_state():
    base = dict(image_size=16, patch_size=8, num_heads=2, hidden_dim=16,
                num_classes=2)

    def fake_fit(seen):
        def fit(model, train_loader, test_loader, epochs, val_loader=None,
                state=None, **kw):
            seen.append((state, kw["lr"], kw["optimizer"]))
            return {"val_accuracy": [0.25 * len(seen)],
                    "final_state": f"state{len(seen)}"}
        return fit

    seen_j, seen_t = [], []
    jtrial = jopt.Trial(_rng=np.random.RandomState(4))
    ttrial = opt.Trial(_rng=np.random.RandomState(4))
    jv = jopt.objective(jtrial, model_cls=lambda **kw: None, base_args=base,
                        train_loader=None, val_loader=None, num_epochs=3,
                        fit_fn=fake_fit(seen_j))
    tv = opt.objective(ttrial, model_cls=lambda **kw: None, base_args=base,
                       train_loader=None, val_loader=None, num_epochs=3,
                       fit_fn=fake_fit(seen_t))
    assert tv == jv == 0.75 and ttrial.params == jtrial.params
    assert seen_t == seen_j
    assert [s[0] for s in seen_t] == [None, "state1", "state2"]


def test_objective_trains_through_the_port_fit():
    """One real trial of two epochs: the second ``fit`` call continues the
    first's state (the same model and optimizer, two epochs of steps)."""
    data = SyntheticLoader(8, 8, 16, 2, seed=0)
    base = dict(image_size=16, patch_size=8, num_heads=2, hidden_dim=16,
                num_classes=2, device="cpu")
    states = []

    def fit(*args, **kwargs):
        from vision_transformers_tpu_torch.training.trainer import fit as f
        hist = f(*args, **kwargs)
        states.append(hist["final_state"])
        return hist

    trial = opt.Trial(_rng=np.random.RandomState(1))
    acc = opt.objective(trial, model_cls=ViT, base_args=base,
                        train_loader=data, val_loader=data, num_epochs=2,
                        fit_fn=fit)
    assert 0.0 <= acc <= 1.0 and len(trial.reports) == 2
    assert states[0] is states[1] and states[1].step == 2
    assert len(states[1].model.encoder.encoder_layer_0.mlp.fc1.bias) == \
        trial.params["mlp_dim"]


def test_plots_match_jax():
    rng = np.random.RandomState(0)
    # NCHW float: both normalise to [0, 1] and transpose; the port takes the
    # torch tensor
    imgs = rng.randint(0, 255, (2, 3, 8, 8)).astype(np.float32)
    want = jviz.plot_patches(imgs, patch_size=4)
    got = viz.plot_patches(torch.from_numpy(imgs), patch_size=4)
    assert len(got.axes) == len(want.axes) == 4
    for a, b in zip(got.axes, want.axes):
        np.testing.assert_array_equal(a.images[0].get_array(),
                                      b.images[0].get_array())
    weights = [rng.rand(1, 3, 5, 5).astype(np.float32) for _ in range(2)]
    want = jviz.plot_attention_maps([jnp.asarray(w) for w in weights],
                                    layer=1, max_heads=2)
    got = viz.plot_attention_maps([torch.from_numpy(w) for w in weights],
                                  layer=1, max_heads=2)
    assert len(got.axes) == len(want.axes)
    for a, b in zip(got.axes, want.axes):
        if a.collections:
            np.testing.assert_array_equal(a.collections[0].get_array(),
                                          b.collections[0].get_array())


def test_public_names_match_jax():
    want, got = jcore.default_policy(), core.default_policy()  # CPU: fp32
    assert str(got.compute_dtype).removeprefix("torch.") == \
        jnp.dtype(want.compute_dtype).name == "float32"
    assert str(got.param_dtype).removeprefix("torch.") == \
        jnp.dtype(want.param_dtype).name
    assert core.Policy().compute_dtype == torch.bfloat16
    cast = core.Policy().cast_to_compute(
        {"w": torch.ones(2), "ids": [torch.arange(3)], "n": 1})
    assert cast["w"].dtype == torch.bfloat16
    assert cast["ids"][0].dtype == torch.int64 and cast["n"] == 1
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert metrics.force_sync(torch.from_numpy(x)) == \
        jmetrics.force_sync(jnp.asarray(x)) == 15.0
    assert metrics.get_sha().startswith("sha: ")
    assert misc.MetricLogger is metrics.MetricLogger
    assert misc.SmoothedValue is metrics.SmoothedValue
    assert misc.accuracy is metrics.accuracy_topk
    assert misc.get_sha is metrics.get_sha


@pytest.mark.parametrize("module", [viz, opt])
def test_tail_modules_import_without_their_optional_packages(module):
    import sys

    for name in ("matplotlib", "seaborn", "optuna"):
        assert name not in module.__dict__
    assert "optuna" not in sys.modules
