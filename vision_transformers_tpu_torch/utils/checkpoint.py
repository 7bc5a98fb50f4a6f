"""Checkpoint / resume.

Counterpart of ``vision_transformers_tpu/utils/checkpoint.py``, with its API:
``save_checkpoint(dir, state, step, keep)`` writes ``dir/step_N``,
``available_checkpoints(dir)`` lists the steps, ``restore_checkpoint(dir,
target, step=None)`` reads the given (or latest) step into ``target``.

The format differs from the JAX package's orbax tree on purpose: one
``state.pt`` per step, written by ``torch.save`` and read by
``torch.load(weights_only=True)`` (tensors, numbers and strings only), which
holds the model's ``state_dict``, the optimizer's state (its moments, update
count and accumulation step) and the train step count of a
``training.trainer.TrainState``. A restore copies into the target's own
tensors, in place, so an optimizer bound to them (``fused=True``) stays
bound. Only rank 0 of a process group writes.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

_FILE = "state.pt"


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _payload(state) -> dict:
    opt = state.optimizer
    return {
        "model": {k: v.detach().cpu() for k, v in
                  state.model.state_dict().items()},
        "optimizer": {
            "count": opt.count, "mini_step": opt.mini_step,
            "state": {k: [t.detach().cpu() for t in v]
                      for k, v in opt.state.items()},
        },
        "step": int(state.step),
    }


def save_checkpoint(ckpt_dir: str, state, step: int,
                    keep: Optional[int] = 3) -> str:
    """Write ``state`` (a ``TrainState``) under ckpt_dir/step_N, keeping the
    newest ``keep`` steps (all when ``keep`` is falsy). Returns the path
    ("" on a rank other than 0, which writes nothing)."""
    if _rank() != 0:
        return ""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(_payload(state), tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    if keep:
        for old in available_checkpoints(ckpt_dir)[:-keep]:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{old}"),
                          ignore_errors=True)
    return path


def available_checkpoints(ckpt_dir: str):
    """The steps saved under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.isfile(
                os.path.join(ckpt_dir, d, _FILE)):
            try:
                out.append(int(d.split("_", 1)[1]))
            except ValueError:
                pass
    return sorted(out)


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, target, step: Optional[int] = None):
    """Read the given (or latest) step into ``target`` (a ``TrainState``
    whose model and optimizer have the checkpoint's structure), in place;
    returns ``target``."""
    steps = available_checkpoints(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
    step = steps[-1] if step is None else step
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}", _FILE)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    target.model.load_state_dict(saved["model"], strict=True)
    opt, got = target.optimizer, saved["optimizer"]
    if set(got["state"]) != set(opt.state):
        raise ValueError(f"optimizer state {sorted(got['state'])} does not "
                         f"match the target's {sorted(opt.state)}")
    for key, tensors in got["state"].items():
        mine = opt.state[key]
        if len(tensors) != len(mine):
            raise ValueError(f"optimizer state {key!r}: {len(tensors)} "
                             f"leaves, the target has {len(mine)}")
        for dst, src in zip(mine, tensors):
            dst.copy_(src)
    opt.count, opt.mini_step = int(got["count"]), int(got["mini_step"])
    target.step = int(saved["step"])
    return target
