"""What the benchmark may import, and that a configuration, a cell and a
per-layer metric are each found as a new file, with no file of the
benchmark edited."""

from __future__ import annotations

import ast
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from portbench import harness  # noqa: E402
from tiny import tiny_tree  # noqa: E402

BENCH = REPO / "portbench"


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub: str = ""):
    return sorted(p for p in (BENCH / sub).rglob("*.py")
                  if "tests" not in p.parts)


def test_no_module_of_the_benchmark_imports_jax():
    for path in _sources():
        bad = _top_level_imports(path) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for sub in ("reference", "arith"):
        for path in _sources(sub):
            names = _top_level_imports(path)
            assert "vision_transformers_tpu_torch" not in names, path
            assert not names & set(harness.FORBIDDEN), path


def test_loading_every_module_loads_no_jax():
    """Every module the command can load, imported in a fresh process,
    with the port's serving and training modules: no JAX there after."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from portbench import harness, calibrate, run\n"
        "import vision_transformers_tpu_torch.serving\n"
        "import vision_transformers_tpu_torch.training.trainer\n"
        "for p in sorted(Path(%r).rglob('*.py')):\n"
        "    if 'tests' not in p.parts and p.name != '__init__.py':\n"
        "        harness.load_module(p)\n"
        "print(harness.forbidden_modules())\n") % (str(REPO), str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlibrary_unrelated", sys)
    assert "jax" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted((root / "portbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_cell_and_metric_are_found_as_new_files(tmp_path):
    root = tiny_tree(tmp_path)
    (root / "portbench" / "metrics" / "probe.infer.py").write_text(
        "def read(ctx):\n    return ctx.batch * 10.5\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "probe.infer", "unit": "1", "better": "higher",
        "source": "program_counter", "layer": "serving",
        "moves": "infer_img_per_s", "workloads": ["tiny_vit.infer"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before, after = _digest(REPO), _digest(root)
    assert all(after[k] == v for k, v in before.items())  # nothing edited
    assert {"portbench/configs/tiny_vit.json",
            "portbench/workloads/tiny_vit.infer.json",
            "portbench/metrics/probe.infer.py"} <= set(after) - set(before)

    cell = harness.Cell("tiny_vit.infer", root)
    assert cell.config["family"] == "vit"
    names = [m["name"] for m in cell.metrics("per_layer")]
    assert "probe.infer" in names and "mfu.infer" in names
    result = harness.run_cell("tiny_vit.infer", 5, 0.2, False, device="cpu",
                              root=root)
    assert set(result["metrics"]) == {"infer_img_per_s", "infer_p95_ms",
                                      "setup_s"}
    assert result["correct"] is True
    assert list(result)[-1] == "compared"
    reader = harness.load_module(root / "portbench" / "metrics"
                                 / "probe.infer.py")
    ctx = harness.Context(cell, 5, torch.device("cpu"))
    measured = {"train": False, "batch": 4, "items": 8, "window_s": 1.0}
    assert reader.read(harness.MetricContext(ctx, measured, None)) == 42.0


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "vit_b16_224.infer_b256", "--seed", "3000000019", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "swin_t_224.infer_b256", "--seed", "3000000023", "--seconds", "3",
         "--trace", str(trace)], cwd=REPO, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]


def test_every_per_layer_metric_has_a_reader(tmp_path):
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        path = harness.reader_path(REPO, m["name"])
        assert path.exists(), m["name"]
        assert callable(harness.load_module(path).read)
    root = tiny_tree(tmp_path)
    own = root / "portbench" / "metrics" / "mfu.infer.py"
    own.write_text("def read(ctx):\n    return 1.0\n")
    assert harness.reader_path(root, "mfu.infer") == own
    assert harness.reader_path(root, "mfu.train").name == "mfu.py"
