"""The port's trainer end to end on the CPU, the package's isolation from
JAX and from the reference package, and the verbatim control-plane copies."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.ft.failures import FailurePlan
from repro_torch.launch.train import SDFLMQTrainer

SRC = Path(__file__).resolve().parents[1] / "src"

COPIED = (
    [f"api/{m}.py" for m in (
        "__init__ async_fl federation fleet mini_broker mqtt_transport "
        "scenarios strategies transport").split()]
    + [f"core/{m}.py" for m in (
        "broker client clustering cohort coordinator defense mqttfc "
        "parameter_server role_optimizer roles session stats topics "
        "topology wire").split()]
    + sorted(str(p.relative_to(SRC / "repro"))
             for p in (SRC / "repro" / "configs").glob("*.py"))
    + ["data/federated.py", "data/synthetic.py", "ft/failures.py"]
    + ["launch/report.py"]
    + [f"obs/{m}.py" for m in
       "__init__ exporters instrument registry tracer".split()]
    + ["train/mlp.py"])


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_trainer_rounds_with_failure_on_cpu():
    cfg = smoke_config(get_arch("qwen2-7b"))
    plan = FailurePlan(fail_at={1: ["c3"]})
    tr = SDFLMQTrainer(cfg, 4, 3, 2, 32, failure_plan=plan, device="cpu")
    metrics = tr.run()
    assert [m["round"] for m in metrics] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) for m in metrics)
    assert tr.weights[3] == 0.0 and (tr.weights[:3] > 0).all()
    assert metrics[1]["n_clients"] == 3
    # the schedule is the coordinator's tree over the bank rows
    tree = tr.coord.tree_of(tr.sid)
    assert "c3" not in tree.client_order
    groups = metrics[-1]["level_groups"][0]
    assert sorted(i for g in groups for i in g) == [0, 1, 2, 3]
    for t in T.leaves(tr.state["params"]):
        assert all(torch.equal(t[k], t[0]) for k in range(4))


def test_train_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--smoke", "--rounds", "2", "--seq", "32"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("round") == 2


def test_package_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'repro' or n.startswith('repro.')]\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 40


def test_no_source_line_imports_jax_or_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
    for p in (SRC / "repro_torch").rglob("*.py"):
        for line in p.read_text().splitlines():
            assert not pat.match(line), f"{p}: {line}"


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = smoke_config(get_arch("qwen2-7b"))
    with pytest.raises(RuntimeError, match="cuda"):
        SDFLMQTrainer(cfg, 2, 1, 1, 8)


@pytest.mark.parametrize("module", COPIED)
def test_control_plane_copy_is_verbatim(module):
    """Each copied numpy-only module equals the reference with every dotted
    ``repro.`` module path pointed at ``repro_torch.``."""
    ref = (SRC / "repro" / module).read_text()
    port = (SRC / "repro_torch" / module).read_text()
    assert port == re.sub(r"\brepro\.", "repro_torch.", ref)
