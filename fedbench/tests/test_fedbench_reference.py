"""The plain reference against a small round of the port on the CPU: the
same inputs, and the same losses, gradients and models to rounding."""
import numpy as np
import pytest
import torch

from fedbench import harness
from fedbench.reference import data, fl
from fedbench.reference.strategies import fedavg
from fedbench.tests import tiny

CELLS = ["qwen2-7b-l1-bank4.fedavg", "mixtral-8x22b-l1-bank4.fedavg",
         "qwen2-7b-l1-bank4.int8"]


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_the_port(name):
    c = tiny.cell(name)
    seed = 2 ** 31 + 17
    trainer, _, readings = harness.program_setup(c, c.config, seed,
                                                 torch.device("cpu"))
    cpu = torch.device("cpu")
    ref = fl.run(c.config, c.traffic, seed, cpu, harness.CHECK_ROUNDS)
    got = harness.compare(readings, ref, cpu)
    assert got["inputs_differ"] == 0 and got["slots_differ"] == 0
    assert got["loss_gap"] < 1e-3
    assert got["grad_gap"] < 0.05
    assert got["agg_gap"] < 1e-3
    assert got["change_gap"] < 0.3


def test_tokens_match_the_data_layer():
    from repro_torch.data.federated import FederatedTokens
    ft = FederatedTokens(1000, 3, seed=99)
    for k in range(3):
        want = ft.client_batch(k, 2, 16, 5)
        got = data.client_tokens(1000, 99, k, 2, 16, 5)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def test_quantize_rows_is_per_row_int8():
    x = torch.tensor([[1.0, -0.5, 0.25], [0.0, 0.0, 0.0]])
    q = fedavg.quantize_rows(x)
    assert torch.equal(q[1], torch.zeros(3))
    assert torch.allclose(q[0], torch.tensor([127, -64, 32]) / 127.0)


@pytest.mark.parametrize("change", [{"strategy": "trimmed_mean"},
                                    {"strategy": "fedprox"},
                                    {"schedule": "hier"}])
def test_reference_refuses_what_it_does_not_model(change):
    c = tiny.cell("qwen2-7b-l1-bank4.fedavg")
    with pytest.raises(ValueError):
        fl.run(c.config, dict(c.traffic, **change), 1, torch.device("cpu"),
               1)


def test_window_keeps_the_learning_rate_horizon(monkeypatch):
    from repro_torch.core.topology import AggSchedule
    from repro_torch.launch import train
    c = tiny.cell("qwen2-7b-l1-bank4.fedavg")
    trainer, _, _ = harness.program_setup(c, c.config, 5,
                                          torch.device("cpu"))
    seen = []
    build = train.build_fl_round_step

    def spy(*args, **kw):
        seen.append(kw["total_steps"])
        return build(*args, **kw)
    monkeypatch.setattr(train, "build_fl_round_step", spy)
    harness.unbounded(trainer)
    trainer._step_for(AggSchedule("flat", c.config["clients"]))
    assert seen == [c.traffic["lr_horizon_rounds"] * c.traffic["local_steps"]]
    assert trainer.rounds > 10 ** 9
