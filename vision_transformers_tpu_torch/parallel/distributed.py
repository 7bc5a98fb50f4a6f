"""Multi-process initialization and host-side collectives.

Counterpart of ``vision_transformers_tpu/parallel/distributed.py``. The JAX
package starts its processes with ``jax.distributed.initialize``; here a
process group of ``torch.distributed`` takes its place: NCCL when the
process's device is CUDA, gloo on the CPU. One process drives one device,
so a rank is what JAX calls a process and a device at once.

``init_distributed_mode`` takes JAX's keyword names
(``coordinator_address``, ``num_processes``, ``process_id``) or torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
``LOCAL_RANK``); with neither it is a no-op. Host-side object gathers
(eval metric merges, COCO result assembly) go through
``all_gather_objects``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from vision_transformers_tpu_torch.core.dtypes import (
    DeviceLike,
    resolve_device,
)


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _info() -> dict:
    world = get_world_size()
    return {"rank": get_rank(), "world_size": world,
            "distributed": world > 1}


def init_distributed_mode(coordinator_address: Optional[str] = None,
                          num_processes: Optional[int] = None,
                          process_id: Optional[int] = None, *,
                          device: DeviceLike = None) -> dict:
    """Join the process group when launched as one of several processes.

    The coordinator is ``coordinator_address`` ("host:port"), else
    ``MASTER_ADDR``:``MASTER_PORT``; the rank and world size are
    ``process_id`` and ``num_processes``, else ``RANK`` and ``WORLD_SIZE``.
    Without any of them it is a no-op that returns the one-process answer.
    ``device`` (CUDA unless ``"cpu"`` is passed) picks the backend: NCCL on
    CUDA, where each rank takes device ``LOCAL_RANK`` (else rank modulo the
    device count) as its current device, and gloo on the CPU. A failing NCCL
    initialization raises; it never falls back to gloo. Returns {"rank",
    "world_size", "distributed"}, as the JAX function does."""
    if _initialized():
        return _info()
    env = os.environ
    rank = process_id if process_id is not None else env.get("RANK")
    world = num_processes if num_processes is not None \
        else env.get("WORLD_SIZE")
    address = coordinator_address
    if address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if rank is None and world is None and address is None:
        return _info()  # one process: nothing to join
    if rank is None or world is None or address is None:
        raise ValueError(
            "a process group needs a rank, a world size and a coordinator "
            f"address; got rank={rank}, world_size={world}, "
            f"address={address}")
    rank, world = int(rank), int(world)
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{address}", rank=rank, world_size=world)
    return _info()


def destroy_distributed_mode() -> None:
    """Leave the process group (if any), so that another can be made."""
    if _initialized():
        dist.destroy_process_group()


def is_main_process() -> bool:
    return get_rank() == 0


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def collective_device() -> torch.device:
    """Where a tensor must be for the default group's collectives: the
    current CUDA device under NCCL, the CPU under gloo."""
    if _initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_host(values) -> np.ndarray:
    """Sum a float64 vector of host numbers over every rank (the
    identity in one process)."""
    arr = np.asarray(values, np.float64)
    if get_world_size() == 1:
        return arr
    t = torch.as_tensor(arr, device=collective_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def all_gather_objects(obj):
    """Gather any picklable object from every rank; a list with one entry
    per rank, in rank order (``[obj]`` in one process)."""
    if get_world_size() == 1:
        return [obj]
    out = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out


def save_on_master(save_fn, *args, **kwargs):
    """Run a save callback on rank 0 only."""
    if is_main_process():
        save_fn(*args, **kwargs)
