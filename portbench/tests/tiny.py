"""A copy of the benchmark's tree with tiny configurations and cells added
as new files, for tests on the CPU. They compute in float32: the plain
versions of the kernels on the CPU give the fp32 reference's answers to
rounding, so a sound run there is correct under the real cells' limits,
whose bf16 readings were taken at full size on the card."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_CONFIGS = {
    "tiny_vit": {
        "family": "vit", "port_class": "ViT", "dtype": "float32",
        "model": {"image_size": 32, "patch_size": 8, "num_layers": 2,
                  "num_heads": 2, "hidden_dim": 64, "mlp_dim": 128,
                  "num_classes": 10, "dropout": 0.0,
                  "attention_dropout": 0.0}},
    "tiny_swin": {
        "family": "swin", "port_class": "SwinTransformer",
        "dtype": "float32",
        "model": {"image_size": 56, "patch_size": [4, 4], "embed_dim": 32,
                  "depths": [2, 2], "num_heads": [1, 2],
                  "window_size": [7, 7], "mlp_ratio": 4.0, "dropout": 0.0,
                  "attention_dropout": 0.0, "stochastic_depth_prob": 0.2,
                  "num_classes": 10}},
}


REAL = {"tiny_vit": "vit_b16_224", "tiny_swin": "swin_t_224"}


def tiny_tree(dest: Path, limits_from_real: bool = True) -> Path:
    """``dest`` holding BENCHMARK.json and portbench/ as the repository has
    them, plus the tiny configurations and a train and an infer cell of
    each, written as new files only. Each takes the control and the limits
    of the real cell of its family and traffic kind."""
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, cfg in TINY_CONFIGS.items():
        real = {kind: json.loads((REPO / "portbench" / "workloads" /
                                  f"{REAL[name]}.{kind}.json").read_text())
                for kind in ("infer_b256", "train_b128")}
        (dest / "portbench" / "configs" / f"{name}.json").write_text(
            json.dumps(cfg))
        for kind, traffic, params in (
                ("infer", "infer_closed", {"batch": 8, "distinct": 2}),
                ("train", "train_steps", dict(
                    real["train_b128"]["params"], batch=8, distinct=4))):
            cell = f"{name}.{kind}"
            source = real["infer_b256" if kind == "infer" else "train_b128"]
            (dest / "portbench" / "workloads" / f"{cell}.json").write_text(
                json.dumps({"config": name, "traffic": traffic,
                            "control": source["control"], "params": params,
                            "limits": source["limits"]}))
            bench["workloads"].append({"name": cell, "config": name,
                                       "traffic": traffic, "chips": 1,
                                       "why": "a CPU test"})
            for m in bench["end_to_end"] + bench["per_layer"]:
                if any(w.endswith("." + kind + ("_b256" if kind == "infer"
                                                else "_b128"))
                       for w in m.get("workloads", [])):
                    m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest
