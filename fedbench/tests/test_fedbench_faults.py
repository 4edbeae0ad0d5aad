"""A whole run, on the CPU at a small size with the look for a card left
out, comes out correct, and with the timed path broken underneath comes
out not correct: a round step that returns its state unchanged, half of
the clients left out of the mean (the mean taken over the rest), and a
token altered where the data layer produces it.  The cells run on one card,
so no exchange between cards can be left out."""
import copy
import numpy as np
import pytest
import torch

from fedbench.tests import tiny
from repro_torch.data import federated
from repro_torch.launch import train

CELLS = ["qwen2-7b-l1-bank4.fedavg", "mixtral-8x22b-l1-bank4.fedavg",
         "qwen2-7b-l1-bank4.int8"]


SEED = 424242


def _run(name, limits):
    return tiny.run(name, SEED, limits)


@pytest.fixture(scope="module")
def limits():
    return {name: tiny.limits(name, SEED) for name in CELLS}


def _wrap_step(monkeypatch, wrap):
    build = train.build_fl_round_step

    def patched(*args, **kw):
        return wrap(build(*args, **kw))
    monkeypatch.setattr(train, "build_fl_round_step", patched)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, limits):
    out = _run(name, limits[name])
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged(monkeypatch, name, limits):
    def wrap(step):
        def unchanged(state, batch, weights):
            _, m = step(copy.deepcopy(state), batch, weights)
            return state, m
        return unchanged
    _wrap_step(monkeypatch, wrap)
    assert not _run(name, limits[name])["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_half_the_clients_left_out_of_the_mean(monkeypatch, name, limits):
    def wrap(step):
        def half(state, batch, weights):
            w = np.array(weights, np.float32)
            w[len(w) // 2:] = 0
            return step(state, batch, w)
        return half
    _wrap_step(monkeypatch, wrap)
    assert not _run(name, limits[name])["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_token_altered_where_produced(monkeypatch, name, limits):
    make = federated.FederatedTokens.global_batch

    def altered(self, *args, **kw):
        b = make(self, *args, **kw)
        b["tokens"][0, 0, 5] = (b["tokens"][0, 0, 5] + 1) % 256
        return b
    monkeypatch.setattr(federated.FederatedTokens, "global_batch", altered)
    assert not _run(name, limits[name])["correct"]
