"""The local step's spans (``repro_torch.obs.spans``) under the CPU
profiler: the phase ranges ``fl/forward``, ``fl/backward`` and
``fl/optimizer``; the decoder's blocks ``fl/attention``, ``fl/ffn`` and
``fl/head``, followed into autograd's backward (and, under remat, the
recompute inside it); the trainer's ``train/...`` ranges; and the MoE's
counts of buffer rows and kept assignments."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tree as T
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core.fl_step import build_fl_round_step, init_state
from repro_torch.core.topology import AggSchedule
from repro_torch.launch.train import SDFLMQTrainer
from repro_torch.models import model_api, moe
from repro_torch.obs import spans

K, B, S = 2, 2, 16
ARCHS = {"dense": "qwen2-7b", "moe": "mixtral-8x22b"}
BLOCKS = ("fl/attention", "fl/ffn", "fl/head")


def _cfg(kind, remat=True):
    return smoke_config(get_arch(ARCHS[kind])).replace(remat=remat)


def _batch(cfg, lead=(K,), seed=0):
    rng = np.random.default_rng(seed)
    shape = lead + (B, S)
    return {"tokens": rng.integers(0, cfg.vocab, shape, dtype=np.int32),
            "labels": rng.integers(0, cfg.vocab, shape, dtype=np.int32)}


def _profiled_round(cfg, local_steps=1, update_filter=None):
    """One round of K clients under the CPU profiler -> (events by name:
    [(start, end)], the round's metrics)."""
    state = init_state(cfg, K, 0, "cpu", update_filter=update_filter)
    step = build_fl_round_step(cfg, K, AggSchedule("flat", K), device="cpu",
                               local_steps=local_steps,
                               update_filter=update_filter)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, m = step(state, _batch(cfg), np.ones(K, np.float32))
    out = {}
    for e in prof.events():
        out.setdefault(e.name, []).append((e.time_range.start,
                                           e.time_range.end))
    return out, m


def _within(iv, ranges):
    return any(s <= iv[0] and iv[1] <= e for s, e in ranges)


def _innermost(t, evs):
    """The program range (``fl/...``) open at ``t`` that opened last."""
    best = None
    for name, rs in evs.items():
        if name.startswith("fl/"):
            for s, e in rs:
                if s <= t <= e and (best is None or s >= best[1]):
                    best = (name, s)
    return best[0] if best else None


def _backward_time(evs, name):
    return [iv for iv in evs.get(name, []) if _within(iv, evs["fl/backward"])]


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_phase_ranges_once_per_client_and_local_step(kind):
    evs, _ = _profiled_round(_cfg(kind), local_steps=2)
    for name in ("fl/forward", "fl/backward", "fl/optimizer"):
        assert len(evs[name]) == K * 2, name
    assert "fl/forward_backward" not in evs
    phases = evs["fl/forward"] + evs["fl/backward"]
    for name in BLOCKS:
        assert evs[name] and all(_within(iv, phases) for iv in evs[name])
    # each block once in the forward and once in the backward of every
    # client step; attention and FFN a layer each, run again by remat
    n = K * 2 * _cfg(kind).n_layers
    fwd = [iv for iv in evs["fl/attention"]
           if _within(iv, evs["fl/forward"])]
    assert len(fwd) == n
    assert len(_backward_time(evs, "fl/head")) == K * 2


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_head_backward_holds_the_head_product_and_no_layer_op(kind):
    evs, _ = _profiled_round(_cfg(kind))
    heads = _backward_time(evs, "fl/head")
    mm = evs["MmBackward0"]
    in_head = [iv for iv in mm if _within(iv, heads)]
    # the output table's product, once a client; the layers' products
    # (attention and MLP projections, the router) lie outside
    assert len(in_head) == K
    for iv in in_head:
        assert _innermost(iv[0], evs) == "fl/head"
    layers = [iv for iv in mm if not _within(iv, heads)]
    assert layers and all(_innermost(iv[0], evs) in ("fl/attention",
                                                      "fl/ffn")
                          for iv in layers)


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_recomputed_attention_falls_inside_attention(kind):
    cfg = _cfg(kind)
    evs, _ = _profiled_round(cfg)
    back = [iv for iv in evs["aten::_softmax"]
            if _within(iv, evs["fl/backward"])]
    where = [_innermost(iv[0], evs) for iv in back]
    # remat runs each layer's forward again inside the backward of the
    # block that needs it first (the FFN): its attention's softmax counts
    # for the attention, the router's (MoE) for the FFN
    assert where.count("fl/attention") == K * cfg.n_layers
    assert set(where) <= {"fl/attention", "fl/ffn"}
    assert where.count("fl/ffn") == (K * cfg.n_layers if kind == "moe"
                                     else 0)
    for iv in back:
        if _innermost(iv[0], evs) == "fl/attention":
            assert _within(iv, _backward_time(evs, "fl/ffn"))


def test_frozen_base_leaves_no_range_open(monkeypatch):
    """With the embedding and the first norm frozen no gradient reaches
    the first layer's attention input: the round step closes that range
    at the end of its backward."""
    left = []
    close = spans.close_open

    def spy():
        left.append(len(spans._open))
        close()
    monkeypatch.setattr(spans, "close_open", spy)
    evs, _ = _profiled_round(_cfg("dense"),
                             update_filter="!embed/*,!layers/ln1/*")
    assert left == [1] * K and spans._open == []
    for name in BLOCKS:
        for iv in _backward_time(evs, name):
            assert _within(iv, evs["fl/backward"])
    # each layer's backward range and its recompute's forward range
    assert len(_backward_time(evs, "fl/attention")) == 2 * K * 2
    # the same round with everything trained closes every range in place
    left.clear()
    _profiled_round(_cfg("dense"))
    assert left == [0] * K


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_marks_leave_gradients_bit_identical(kind, remat, monkeypatch):
    cfg = _cfg(kind, remat)
    params = init_state(cfg, 1, 3, "cpu")["params"]
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, ()).items()}

    def grads():
        live = [p.detach().requires_grad_(True) for p in T.leaves(params)]
        loss, _ = model_api.loss_fn(cfg, T.unflatten_like(params, live),
                                    batch)
        return [loss.detach()] + list(torch.autograd.grad(loss, live))
    marked = grads()
    assert spans._open == []
    monkeypatch.setattr(spans, "block", lambda name, fn, x, *a: fn(x, *a))
    bare = grads()
    assert len(marked) == len(bare)
    for a, b in zip(marked, bare):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_marks_save_nothing_and_build_no_node_without_grad():
    x = torch.randn(4, 8, requires_grad=True)
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: packed.append(t) or t, lambda t: t):
        y, z = spans.block("fl/test", lambda t: (t * 1, t.detach()), x)
    assert packed == []
    assert type(y.grad_fn).__name__ == "_OutMarkBackward"
    assert z.grad_fn is None                 # no gradient: left unmarked
    with torch.no_grad():
        y = spans.block("fl/test", lambda t: t * 2, x)
    assert y.grad_fn is None
    with torch.inference_mode():
        y = spans.block("fl/test", lambda t: t * 2, torch.ones(3))
    assert y.grad_fn is None and spans._open == []


def test_close_open_closes_every_range_left_open():
    """Blocks whose input takes no gradient open their backward ranges
    and leave them to ``close_open``, which closes them all."""
    w = torch.randn(3, requires_grad=True)
    x = torch.randn(3)
    ys = [spans.block(f"fl/t{i}", lambda t: t * w, x) for i in range(3)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sum(y.sum() for y in ys).backward()
        assert len(spans._open) == 3
        spans.close_open()
    assert spans._open == []
    names = [e.name for e in prof.events()]
    assert all(names.count(f"fl/t{i}") == 1 for i in range(3))


def test_moe_counts_buffer_rows_and_kept_assignments():
    # capacity factor 0.5 drops assignments
    cfg = _cfg("moe", remat=False)
    cfg = cfg.replace(moe=cfg.moe.__class__(**{
        **cfg.moe.__dict__, "capacity_factor": 0.5}))
    E, top_k, T_ = cfg.moe.n_experts, cfg.moe.top_k, B * S
    cap = moe.capacity(T_, cfg.moe)
    moe.reset_stats()
    p = T.tree_map(lambda t: t[0], init_state(cfg, 1, 0, "cpu")
                   ["params"]["layers"]["moe"])
    moe.moe_apply_dense(cfg, p, torch.randn(B, S, cfg.d_model,
                                            dtype=torch.bfloat16))
    st = moe.read_stats()
    assert st["calls"] == 1 and st["rows"] == E * cap
    assert st["assignments"] == T_ * top_k and st["dropped"] > 0

    moe.reset_stats()
    _, m = _profiled_round(cfg)
    st = moe.read_stats()
    calls = K * cfg.n_layers
    assert st["calls"] == calls and st["rows"] == calls * E * cap
    assert m["moe_rows"] == st["rows"]
    assert int(m["moe_kept"]) == calls * T_ * top_k - st["dropped"]
    assert st["dropped"] > 0


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_trainer_ranges_and_moe_metrics(kind):
    tr = SDFLMQTrainer(_cfg(kind, remat=False), K, 2, B, S, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        metrics = tr.run()
    names = [e.name for e in prof.events()]
    for name in ("train/schedule", "train/batch", "train/step",
                 "train/wait", "train/round_end"):
        assert names.count(name) == 2, name
    if kind == "dense":
        assert "moe_rows" not in metrics[0]
        return
    for m in metrics:
        assert type(m["moe_kept"]) is int and 0 < m["moe_kept"] <= \
            m["moe_rows"]


def test_chip_smoke_frontend_trainer_reads_the_round_spans():
    """``chip_smoke._FrontendTrainer`` (the encoder-decoder and VLM legs
    on the card) reads its rounds' spans through ``obs.spans.span_ms``."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    mod_spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(chip_smoke)
    cfg = smoke_config(get_arch("whisper-small"))
    rows = chip_smoke._FrontendTrainer(cfg, K, 2, 1, S,
                                       device=torch.device("cpu")).run()
    assert [r["round"] for r in rows] == [0, 1]
    for r in rows:
        assert np.isfinite(r["loss"]) and r["rank_ms"] == {}
