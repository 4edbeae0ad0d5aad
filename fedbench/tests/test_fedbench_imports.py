"""What a run loads: no JAX and not the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's), and a
reference that loads nothing of the port."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FEDBENCH = ROOT / "fedbench"


def _loaded(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=f"{ROOT}:{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_run_closure_loads_no_jax_nor_the_jax_package():
    code = ("import runpy; runpy.run_path('fedbench/run.py')\n"
            "from fedbench import cells, harness, calibrate\n"
            "from fedbench.reference.strategies import fedavg\n"
            "from repro_torch.launch.train import SDFLMQTrainer\n"
            "for w in cells.benchmark()['workloads']:\n"
            "    cells.resolve(w['name'])\n")
    names = _loaded(code)
    assert "repro_torch" in names and "fedbench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_port():
    names = _loaded("import fedbench.reference.fl\n"
                    "import fedbench.reference.strategies.fedavg")
    assert "repro_torch" not in names and "repro" not in names
    for path in (FEDBENCH / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            for m in mods:
                assert m.split(".")[0] not in ("repro", "repro_torch", "jax")


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "fedbench/run.py", "--workload",
         "qwen2-7b-l1-bank4.fedavg", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_run_with_only_the_benchmark_files_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(FEDBENCH, tmp_path / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "fedbench/run.py", "--workload",
         "qwen2-7b-l1-bank4.fedavg", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout == ""
