"""The local step's readers on a hand-made trace: the phases, the blocks
by the innermost-range rule (the backward's blocks and remat's recompute
inside them), the roofline's arithmetic and the MoE's row share; each
reader None where its range or count is absent."""
import pytest

from fedbench import cells
from fedbench.harness import Context
from fedbench.metrics import (attention_ms, backward_ms, ffn_ms, forward_ms,
                              head_ms, innermost, local_step_roofline,
                              moe_row_share)
from fedbench.trace import WINDOW, Trace

# one client step: the forward's three blocks, then the backward's, the
# FFN's holding the layer's recompute (attention, then FFN), then the
# optimizer
RANGES = [(WINDOW, 0.0, 40.0),
          ("fl/forward", 0.0, 10.0), ("fl/attention", 1.0, 3.0),
          ("fl/ffn", 3.0, 6.0), ("fl/head", 6.0, 9.0),
          ("fl/backward", 10.0, 30.0), ("fl/head", 10.5, 13.0),
          ("fl/ffn", 13.0, 22.0), ("fl/attention", 14.0, 16.0),
          ("fl/ffn", 16.0, 18.0), ("fl/attention", 22.0, 28.0),
          ("fl/optimizer", 30.0, 35.0)]
# (host time of the launch, device seconds)
LAUNCHES = [(2.0, 1.0), (4.0, 2.0), (7.0, 3.0),          # forward
            (11.0, 4.0), (15.0, 0.5), (17.0, 0.25),      # head, recompute
            (20.0, 5.0), (25.0, 2.0), (29.0, 0.125),     # ffn, attn, glue
            (32.0, 3.0), (38.0, 1.0)]                    # optimizer, outside


def _trace(ranges=RANGES):
    return Trace(kernels=[(f"k{i}", 100.0 + i, 100.0 + i + d, at)
                          for i, (at, d) in enumerate(LAUNCHES)],
                 ranges=list(ranges), window=(0.0, 40.0))


def _ctx(trace, rounds=2, window_rounds=(), sizes=None, traffic=None):
    return Context(trace=trace, profiled_rounds=rounds,
                   window_rounds=list(window_rounds), sizes=sizes,
                   traffic=traffic)


def test_innermost_credits_each_kernel_to_the_range_opened_last():
    assert innermost.device_s(_trace()) == pytest.approx(
        {"fl/attention": 1.0 + 0.5 + 2.0, "fl/ffn": 2.0 + 0.25 + 5.0,
         "fl/head": 3.0 + 4.0, "fl/backward": 0.125, "fl/optimizer": 3.0})


def test_blocks_and_phases_a_round():
    ctx = _ctx(_trace())
    # remat's recomputed attention (launch 15, inside the backward's FFN)
    # counts for the attention
    assert attention_ms.read(ctx) == pytest.approx(1e3 * 3.5 / 2)
    assert ffn_ms.read(ctx) == pytest.approx(1e3 * 7.25 / 2)
    assert head_ms.read(ctx) == pytest.approx(1e3 * 7.0 / 2)
    assert forward_ms.read(ctx) == pytest.approx(1e3 * 6.0 / 2)
    assert backward_ms.read(ctx) == pytest.approx(1e3 * 11.875 / 2)


def test_local_step_roofline_arithmetic():
    sizes = cells.resolve("qwen2-7b-l1-bank4.fedavg").config   # K = 4
    traffic = {"batch_per_client": 1, "seq_len": 2048, "local_steps": 1}
    ctx = _ctx(_trace(), rounds=1, sizes=sizes, traffic=traffic)
    # 4 x 2048 tokens a round at 4 712 322 048 FLOPs each
    # (test_fedbench_arith), over 17.875 device s of forward and backward
    want = 100.0 * 4 * 2048 * 4_712_322_048 / 989e12 / 17.875
    assert local_step_roofline.read(ctx) == pytest.approx(want)


def test_moe_row_share_from_round_counts():
    rounds = [{"moe_rows": 4 * 65536, "moe_kept": 4 * 16384},
              {"moe_rows": 4 * 65536, "moe_kept": 4 * 16384 - 8}]
    got = moe_row_share.read(_ctx(None, window_rounds=rounds))
    assert got == pytest.approx(100.0 * (8 * 16384 - 8) / (8 * 65536))
    assert moe_row_share.read(_ctx(None, window_rounds=[{"loss": 1.0}])) \
        is None


@pytest.mark.parametrize("reader", [forward_ms, backward_ms, attention_ms,
                                    ffn_ms, head_ms, local_step_roofline])
def test_readers_find_nothing_without_their_ranges(reader):
    """A program with one range around forward and backward, as before
    the local step had its own: every reader returns None."""
    parent = [(WINDOW, 0.0, 40.0), ("fl/forward_backward", 0.0, 30.0),
              ("fl/optimizer", 30.0, 35.0)]
    sizes = cells.resolve("qwen2-7b-l1-bank4.fedavg").config
    traffic = {"batch_per_client": 1, "seq_len": 2048, "local_steps": 1}
    assert reader.read(_ctx(_trace(parent), sizes=sizes,
                            traffic=traffic)) is None
