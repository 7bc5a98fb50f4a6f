"""Sets of runs of one cell, each a fresh process, and their spreads; the
measurements that the bounds of ``BENCHMARK.json`` are set from. Not run
by the benchmark's own runs.

    python3 portbench/sets.py --workload <cell> --seeds 1,2,3,4,5,6 \
        --sets 2 --seconds 20 [--trace-seeds 7,8,9] --out FILE.jsonl

Each set runs every seed once, in order; ``--trace-seeds`` adds runs with
``--trace 1``. Every run's result line (with its exit code and wall time)
goes to ``--out``; the summary gives, for each set and end-to-end metric,
the median and the spread: the distance between the first and the third
quartile (``statistics.quantiles(values, n=4)``) over the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def one_run(cell: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         cell, "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True)
    lines = out.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if out.returncode == 0 and lines else None
    return {"cell": cell, "seed": seed, "trace": trace,
            "rc": out.returncode, "wall_s": time.perf_counter() - t0,
            "result": result, "stderr_tail": out.stderr[-1500:]}


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = [(k, s, 0) for k in range(args.sets) for s in seeds] + [
        (-1, int(s), 1) for s in args.trace_seeds.split(",") if s]
    by_set = {}
    with open(args.out, "a") as f:
        for k, seed, trace in runs:
            rec = dict(one_run(args.workload, seed, args.seconds, trace),
                       set=k)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            res = rec["result"]
            print(json.dumps({"set": k, "seed": seed, "rc": rec["rc"],
                              "wall_s": round(rec["wall_s"], 1),
                              "correct": res and res["correct"],
                              "metrics": res and {
                                  m: v["value"] for m, v in
                                  res["metrics"].items()},
                              "compared": res and res["compared"]}),
                  flush=True)
            if res is None:
                print(rec["stderr_tail"], flush=True)
            elif trace == 0:
                for m, v in res["metrics"].items():
                    by_set.setdefault(m, {}).setdefault(k, []).append(
                        v["value"])
    summary = {m: {k: {"median": statistics.median(v), "spread": spread(v)}
                   for k, v in sets.items() if len(v) >= 2}
               for m, sets in by_set.items()}
    print(json.dumps({"cell": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
