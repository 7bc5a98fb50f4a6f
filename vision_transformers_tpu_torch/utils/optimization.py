"""Hyperparameter optimization.

Counterpart of ``vision_transformers_tpu/utils/optimization.py``: an
``objective`` over the reference's search space (num_layers, mlp_dim,
dropouts, lr, optimizer in {Adam, SGD, RMSprop}) that trains through the
port's ``training.trainer.fit`` and reports each epoch's validation accuracy
for median pruning, and ``run_study``, a random-search driver with its own
``Trial`` and ``Study``. ``objective`` also takes an optuna trial where
optuna is installed (it only calls ``suggest_*``, ``report`` and
``should_prune``); this module never imports it.

The model and its optimizer state carry across epochs: each epoch is one
``fit(..., epochs=1, state=state)`` call on the same model, continuing from
the ``final_state`` the previous call returned, as the JAX function passes
its train state along. ``base_args`` are the model's constructor kwargs,
``device`` among them (the port's models default to CUDA).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np


SEARCH_SPACE = {
    "num_layers": (2, 8),                 # int range
    "mlp_dim": [256, 512, 1024],          # categorical
    "dropout": (0.0, 0.3),                # float range
    "attention_dropout": (0.0, 0.3),
    "lr": (1e-5, 1e-2, "log"),
    "optimizer": ["adam", "sgd", "rmsprop"],
}


class TrialPruned(Exception):
    pass


@dataclass
class Trial:
    """Minimal optuna-compatible trial for the fallback search."""

    params: Dict[str, Any] = field(default_factory=dict)
    reports: List[float] = field(default_factory=list)
    _rng: np.random.RandomState = field(
        default_factory=lambda: np.random.RandomState(0))
    _median_history: Optional[List[List[float]]] = None

    def suggest_int(self, name, low, high):
        v = int(self._rng.randint(low, high + 1))
        self.params[name] = v
        return v

    def suggest_float(self, name, low, high, log=False):
        if log:
            v = float(np.exp(self._rng.uniform(np.log(low), np.log(high))))
        else:
            v = float(self._rng.uniform(low, high))
        self.params[name] = v
        return v

    def suggest_categorical(self, name, choices):
        v = choices[int(self._rng.randint(len(choices)))]
        self.params[name] = v
        return v

    def report(self, value, step):
        self.reports.append(float(value))

    def should_prune(self) -> bool:
        """Median pruning: prune if current value is below the median of
        completed trials at the same step."""
        if not self._median_history or not self.reports:
            return False
        step = len(self.reports) - 1
        peers = [h[step] for h in self._median_history if len(h) > step]
        if len(peers) < 2:
            return False
        return self.reports[-1] < float(np.median(peers))


def objective(trial, *, model_cls, base_args: Dict[str, Any],
              train_loader, val_loader, num_epochs: int = 3,
              fit_fn: Optional[Callable] = None) -> float:
    """Suggest hyperparameters, build ``model_cls(**base_args, ...)``,
    train it ``num_epochs`` epochs (one ``fit_fn`` call each, the state
    carried), report each epoch's validation accuracy for pruning and return
    the last."""
    from vision_transformers_tpu_torch.training.trainer import fit

    fit_fn = fit_fn or fit
    args = dict(base_args)
    args["num_layers"] = trial.suggest_int("num_layers", *SEARCH_SPACE["num_layers"])
    args["mlp_dim"] = trial.suggest_categorical("mlp_dim", SEARCH_SPACE["mlp_dim"])
    args["dropout"] = trial.suggest_float("dropout", 0.0, 0.3)
    args["attention_dropout"] = trial.suggest_float("attention_dropout", 0.0, 0.3)
    lr = trial.suggest_float("lr", 1e-5, 1e-2, log=True)
    optimizer = trial.suggest_categorical("optimizer", SEARCH_SPACE["optimizer"])

    model = model_cls(**args)
    acc = 0.0
    state = None  # carried across epochs so training is progressive
    for epoch in range(num_epochs):
        hist = fit_fn(
            model, train_loader, val_loader, epochs=1,
            val_loader=val_loader, lr=lr, optimizer=optimizer, verbose=False,
            state=state,
        )
        state = hist.get("final_state", None)
        acc = hist["val_accuracy"][-1]
        trial.report(acc, epoch)
        if trial.should_prune():
            raise TrialPruned()
    return acc


@dataclass
class Study:
    trials: List[Trial] = field(default_factory=list)
    values: List[Optional[float]] = field(default_factory=list)

    @property
    def best_trial(self) -> Trial:
        best = int(np.nanargmax([v if v is not None else np.nan
                                 for v in self.values]))
        return self.trials[best]

    @property
    def best_value(self) -> float:
        return float(np.nanmax([v if v is not None else np.nan
                                for v in self.values]))


def run_study(objective_fn: Callable[[Trial], float], n_trials: int = 10,
              seed: int = 0) -> Study:
    """Random-search driver with median pruning: trial i draws from
    ``RandomState(seed + i)``; a pruned trial's value is None."""
    study = Study()
    history: List[List[float]] = []
    for i in range(n_trials):
        trial = Trial(_rng=np.random.RandomState(seed + i))
        trial._median_history = history
        try:
            value = objective_fn(trial)
            study.values.append(value)
        except TrialPruned:
            study.values.append(None)
        study.trials.append(trial)
        history.append(trial.reports)
    return study
