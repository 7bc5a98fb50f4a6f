"""Run one cell of the benchmark of the PyTorch/CUDA port once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds the port
(``vision_transformers_tpu_torch``). It needs as many CUDA cards as the
cell asks for and never measures the CPU. The last line of standard output
is the result as one JSON object; the numbers of the correctness check are
the last lines of standard error. With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, the
device's busy time and the traced window, and a breakdown.

Exit codes: 0 with a result; 2 without the cards the cell needs; 3 when a
module of JAX or of the JAX package was loaded; anything else is a fault.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from portbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        print(f"loaded modules the run may not load: {found}",
              file=sys.stderr)
        return 3
    for key, c in result["compared"].items():
        print(f"{key} {c['value']:.6g} limit {c['limit']:.6g}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
