"""One run of one cell: set-up, the measured window, the traced part, the
check against the plain reference, and the result line.

Everything that belongs to one configuration, one cell or one per-layer
metric sits in a file of its own and is found by name:

- ``configs/<config>.json``: the model's sizes, its family and the port's
  class; ``reference/<family>.py`` (the plain fp32 model) and
  ``arith/<family>.py`` (its operation counts) beside it;
- ``workloads/<cell>.json``: the configuration, the traffic kind, its
  parameters, the control and the limits of the check;
- ``traffic/<kind>.py``: the loop that drives the program;
- ``metrics/<name>.py``: one per-layer metric's reader, ``read(ctx)``,
  which returns a number or None when it finds nothing to read; where a
  name has no file of its own, ``metrics/<stem>.py`` of its part before
  the last dot reads it (one reader for ``mfu.infer`` and ``mfu.train``);
- ``BENCHMARK.json`` at the root: which metrics each cell reports.

The program under test is the port, ``vision_transformers_tpu_torch``; it
is imported only through the traffic modules and ``Context.program_model``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import zlib
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

import numpy as np
import torch

from portbench import trace as tracing

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vision_transformers_tpu")
TRACED_ITERS = 4


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A module from its file, whatever characters its name holds."""
    tag = "portbench_" + "".join(c if c.isalnum() else "_"
                                 for c in str(path.relative_to(path.parents[1])))
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run may not load,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def process_age() -> float:
    """Seconds since this process started (Linux: start time and uptime in
    clock ticks of 1/100 s)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def seed_of(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (weights, inputs, ...) of the run's seed."""
    ss = np.random.SeedSequence(entropy=int(seed) % 2 ** 64,
                                spawn_key=(zlib.crc32(tag.encode()),))
    lo, hi = ss.generate_state(2, np.uint32)
    return (int(hi) << 32 | int(lo)) & (2 ** 63 - 1)


def host_array(t: torch.Tensor) -> np.ndarray:
    """``t`` copied into an array of numpy's own allocation, as a client's
    images are (numpy asks the kernel for huge pages for large arrays)."""
    out = np.empty(tuple(t.shape), dtype=np.dtype(str(t.dtype).split(".")[1]))
    torch.from_numpy(out).copy_(t)
    return out


class Cell:
    """The files of one cell, found by its name."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = root / "portbench"
        self.name = name
        self.workload = load_json(bench / "workloads" / f"{name}.json")
        self.config = load_json(
            bench / "configs" / f"{self.workload['config']}.json")
        family = self.config["family"]
        self.reference = load_module(bench / "reference" / f"{family}.py")
        self.arith = load_module(bench / "arith" / f"{family}.py")
        self.traffic = load_module(
            bench / "traffic" / f"{self.workload['traffic']}.py")
        self.benchmark = load_json(root / "BENCHMARK.json")

    def metrics(self, kind: str) -> list:
        """This cell's entries of ``end_to_end`` or ``per_layer``."""
        return [m for m in self.benchmark[kind]
                if "workloads" not in m or self.name in m["workloads"]]


class Context:
    """What a traffic loop and a metric reader see of the run."""

    def __init__(self, cell: Cell, seed: int, device: torch.device):
        self.cell = cell
        self.seed = seed
        self.device = device
        self.model_cfg = cell.config["model"]
        self.params = cell.workload["params"]
        self.dtype = cell.config["dtype"]
        self.notes: Dict[str, object] = {}

    def seed_of(self, tag: str) -> int:
        return seed_of(self.seed, tag)

    def weights(self, requires_grad: bool = False) -> Dict[str, torch.Tensor]:
        """Every leaf of the model, made on the device from the run's seed
        in one draw of normals, each leaf then scaled and shifted as the
        reference's ``param_spec`` says (fp32, as the program keeps them)."""
        spec = self.cell.reference.param_spec(self.model_cfg)
        total = sum(math.prod(s[1]) for s in spec)
        gen = torch.Generator(device=self.device).manual_seed(
            self.seed_of("weights"))
        flat = torch.randn(total, generator=gen, device=self.device)
        out, off = {}, 0
        for name, shape, std, mean in spec:
            n = math.prod(shape)
            leaf = flat[off: off + n].view(shape).mul_(std).add_(mean)
            out[name] = (leaf.clone().requires_grad_() if requires_grad
                         else leaf)
            off += n
        return out

    def program_model(self):
        """The port's model of this configuration, on the device, in the
        configuration's compute dtype (its own initial weights, which the
        caller replaces)."""
        from vision_transformers_tpu_torch.models import image_classification

        cls = getattr(image_classification, self.cell.config["port_class"])
        return cls(**self.model_cfg, dtype=self.dtype, device=self.device)


class MetricContext:
    """What a per-layer metric's reader gets: the configuration and its
    arithmetic, the measured window and the traced iterations."""

    def __init__(self, ctx: Context, measured: dict,
                 profile: Optional[tracing.Profile]):
        self.model_cfg = ctx.model_cfg
        self.arith = ctx.cell.arith
        self.train = measured["train"]
        self.batch = measured["batch"]
        self.items = measured["items"]
        self.window_s = measured["window_s"]
        self.profile = profile


def reader_path(root: Path, name: str) -> Path:
    """The reader of per-layer metric ``name``: its own file, or that of its
    stem."""
    metrics = root / "portbench" / "metrics"
    own = metrics / f"{name}.py"
    return own if own.exists() else metrics / f"{name.rsplit('.', 1)[0]}.py"


def compare(readings: Dict[str, float], limits: Dict[str, float]):
    """{name: (value, limit)} and whether every value is within its
    limit (a value that is not a number is not)."""
    out = {k: (float(readings[k]), float(limits[k])) for k in limits}
    ok = all(math.isfinite(v) and v <= lim for v, lim in out.values())
    return out, ok


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT) -> dict:
    """One run of cell ``name``; returns the result line's object."""
    cell = Cell(name, root)
    dev = torch.device(device)
    ctx = Context(cell, seed, dev)
    loop = cell.traffic.Traffic(ctx)
    loop.setup()
    setup_s = process_age()
    measured = loop.run(seconds)
    profile = None
    if trace:
        profile = tracing.traced(loop.iteration, TRACED_ITERS)
        if profile is not None:
            ctx.notes["trace"] = profile.summary()
        ctx.notes["power"] = power_limit()
    info = device_info(dev)
    loop.release()
    readings = loop.readings()
    compared, ok = compare(readings, cell.workload["limits"])
    for key, value in ctx.notes.items():
        log(f"note {key}: {value}")

    if trace:
        mctx = MetricContext(ctx, measured, profile)
        metrics = {}
        for m in cell.metrics("per_layer"):
            value = load_module(reader_path(root, m["name"])).read(mctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if profile is not None:
            info["busy_s"] = profile.busy_s()
            info["window_s"] = profile.window_s
    else:
        values = dict(measured["end_to_end"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.metrics("end_to_end")}
    result = {"correct": ok, "attempted": measured["attempted"],
              "failed": measured["failed"], "metrics": metrics,
              "device": info}
    if trace and profile is not None:
        result["breakdown"] = {"device_ops": profile.top_ops(),
                               "idle_gaps": [list(g) for g in profile.gaps]}
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in compared.items()}
    return result
