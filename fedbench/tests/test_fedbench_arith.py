"""The yardstick's arithmetic on hand-worked shapes."""
import pytest
import torch

from fedbench import cells, flops
from fedbench.trace import WINDOW, Trace

ONE = dict(hidden_size=2, vocab_size=3, num_hidden_layers=1,
           num_attention_heads=1, num_key_value_heads=1, head_dim=2,
           intermediate_size=4, qkv_bias=False, clients=1,
           optimizer="adamw")


def test_model_flops_qwen2_one_layer():
    s = cells.resolve("qwen2-7b-l1-bank4.fedavg").config
    # 3584^2 * 2 + 3584 * 512 * 2 + 3 * 3584 * 18944 + 152064 * 3584
    assert flops.matmul_params_per_token(s) == 778_043_392
    # 4 * 28 * 128 * (2048 * 2049 / 2) / 2048, forward and backward
    assert flops.attention_flops_per_token(s, 2048) == pytest.approx(
        44_061_696)
    assert flops.model_flops_per_token(s, 2048) == pytest.approx(
        4_712_322_048)


def test_model_flops_mixtral_one_layer_counts_top2_experts():
    s = cells.resolve("mixtral-8x22b-l1-bank4.fedavg").config
    # attention 88 080 384, two experts 603 979 776, router 49 152,
    # output table 201 326 592
    assert flops.matmul_params_per_token(s) == 893_435_904
    assert flops.model_flops_per_token(s, 2048) == pytest.approx(
        5_436_149_760)


@pytest.mark.parametrize("seq,window,pairs", [(4, None, 10), (5, 2, 9),
                                              (5, 8, 15)])
def test_causal_pairs(seq, window, pairs):
    assert flops.causal_pairs(seq, window) == pairs


def test_flash_fwd_cost():
    s = dict(ONE, hidden_size=16, num_attention_heads=2, head_dim=8)
    f, b = flops.flash_fwd_cost(s, batch=1, seq=4)
    assert f == 4 * 2 * 8 * 10
    assert b == (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8) * 2 + 2 * 4 * 4


@pytest.mark.parametrize("optimizer,nbytes", [("adamw", 1312),
                                              ("adafactor", 848)])
def test_optimizer_bytes(optimizer, nbytes):
    # 52 bf16 and 6 f32 elements; AdamW: p r/w, g r, two f32 moments r/w;
    # Adafactor: p r/w, g r, the factors (or a 1-D leaf's v) r/w
    assert flops.optimizer_bytes(dict(ONE, optimizer=optimizer)) == nbytes
    assert flops.optimizer_bytes(dict(ONE, optimizer=optimizer,
                                      clients=4)) == 4 * nbytes


@pytest.mark.parametrize("schedule,nbytes", [("tree", 384),
                                             ("compressed", 1016)])
def test_aggregate_bytes(schedule, nbytes):
    # K = 2: three passes over 52 bf16 and 6 f32 elements; compressed adds
    # the int8 payloads (58 a client, written and read) and 25 row scales
    assert flops.aggregate_bytes(dict(ONE, clients=2), schedule) == nbytes


def test_trace_idle_share_and_gaps():
    # kernels (name, start, end, host time of their launch)
    t = Trace(kernels=[("a", 1.0, 3.0, 0.2), ("b", 2.0, 4.0, 3.6),
                       ("c", 6.0, 7.0, 5.0)],
              ranges=[("train/batch", 0.0, 1.5), ("fl/optimizer", 3.5, 6.5),
                      (WINDOW, 0.0, 10.0)],
              window=(0.0, 10.0))
    assert t.busy_s() == 4.0 and t.window_s() == 10.0
    assert t.idle_gaps() == {"train/batch": 1.0, "fl/optimizer": 2.0,
                             "outside any range": 3.0}
    # b and c were launched inside the optimizer's range: 2 + 1 device s
    assert t.range_totals("fl/optimizer") == (3.0, 3.0, 1)
    assert t.breakdown()["device_ops"][0] == ["a", 2.0]


def test_trace_reads_a_profiler():
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            with record_function("train/batch"):
                torch.ones(8).sum()
    t = Trace.from_profiler(prof)
    assert t.range_totals("train/batch")[2] == 1
    assert t.window_s() > 0
