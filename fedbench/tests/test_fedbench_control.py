"""The controls, put in the program's place, come out as not correct at a
size a test run holds, on the CPU: the reference one precision step below
the bf16 that the configurations state (fp8 products), and where the
traffic sends int8 payloads, the reference with the int8 codec left out."""
import pytest
import torch

from fedbench import harness
from fedbench.calibrate import RefReadings
from fedbench.reference import fl
from fedbench.tests import tiny

SEED = 977


@pytest.mark.parametrize("name", ["qwen2-7b-l1-bank4.fedavg",
                                  "mixtral-8x22b-l1-bank4.fedavg",
                                  "qwen2-7b-l1-bank4.int8"])
def test_control_is_not_correct(name):
    c = tiny.cell(name)
    lim = tiny.limits(name, SEED)
    cpu = torch.device("cpu")
    R = harness.CHECK_ROUNDS
    ref = fl.run(c.config, c.traffic, SEED, cpu, R)
    control = RefReadings(fl.run(c.config, c.traffic, SEED, cpu, R,
                                 precision="fp8"), R, torch.bfloat16)
    correct, checks = harness.judge(harness.compare(control, ref, cpu), lim)
    assert not correct, checks


def test_int8_left_out_is_not_correct():
    name = "qwen2-7b-l1-bank4.int8"
    c = tiny.cell(name)
    lim = tiny.limits(name, SEED)
    cpu = torch.device("cpu")
    R = harness.CHECK_ROUNDS
    ref = fl.run(c.config, c.traffic, SEED, cpu, R)
    plain = RefReadings(fl.run(c.config, dict(c.traffic, schedule="tree"),
                               SEED, cpu, R), R, torch.bfloat16)
    numbers = harness.compare(plain, ref, cpu)
    correct, checks = harness.judge(numbers, lim)
    assert not correct and numbers["agg_gap"] > lim["agg_gap"]["limit"], \
        checks
