"""Readings that the limits of a cell's check are set from; not run by the
benchmark's own runs.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2]

In one process, for each seed of ``--seeds``: the program's sound run
(set-up, a short window at the cell's own load, the check's readings); for
each of ``--control-seeds``: the control, the configuration's lower
precision in the program's place (``control`` in the cell's file:
``reference_fp8``, the reference with every product's operands in float8
e4m3), and for a training cell also the reference with half of each batch
left out of the loss (a fault). One JSON line per reading, then a summary:
the largest sound reading and the smallest control and fault readings of
each number.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(cell, seed, device, seconds, kind):
    import torch

    from portbench import harness

    ctx = harness.Context(cell, seed, device)
    loop = cell.traffic.Traffic(ctx)
    loop.setup()
    loop.run(seconds)
    loop.release()
    if kind == "program":
        out = loop.readings()
    elif kind == "control":
        out = loop.control_readings()
    else:
        out = loop.half_batch_readings()
    del loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def calibrate(name, seeds, control_seeds, seconds, device="cuda",
              root=ROOT, emit=print):
    """{kind: {number: [readings]}} over the seeds."""
    import torch

    from portbench import harness

    cell = harness.Cell(name, root)
    dev = torch.device(device)
    kinds = [("program", s) for s in seeds] + [
        ("control", s) for s in control_seeds]
    if cell.traffic.Traffic.train:
        kinds += [("half_batch", s) for s in control_seeds]
    table = {}
    for kind, seed in kinds:
        got = readings(cell, seed, dev, seconds, kind)
        emit(json.dumps({"cell": name, "kind": kind, "seed": seed, **got}))
        for k, v in got.items():
            table.setdefault(kind, {}).setdefault(k, []).append(v)
    return table


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    table = calibrate(args.workload, ints(args.seeds),
                      ints(args.control_seeds), args.seconds)
    summary = {kind: {k: (max(v) if kind == "program" else min(v))
                      for k, v in nums.items()}
               for kind, nums in table.items()}
    print(json.dumps({"cell": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
