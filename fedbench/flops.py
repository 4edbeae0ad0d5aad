"""The yardstick's arithmetic, counted from the configuration's sizes: the
chip's peaks, the model FLOPs of a token, the bytes the optimizer and the
aggregation need, and the attention forward's FLOPs and bytes.

Peaks: NVIDIA H100 SXM data sheet, dense bf16 989 TFLOP/s and 3.35 TB/s of
HBM3, at the full 700 W power limit.
"""
from __future__ import annotations

import math

from fedbench import weights as W

PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def _sizes(s: dict):
    return (s["hidden_size"], s["num_attention_heads"],
            s["num_key_value_heads"], s["head_dim"], s["intermediate_size"],
            s["vocab_size"], s["num_hidden_layers"])


def causal_pairs(seq: int, window=None) -> int:
    """(query, key) pairs a causal mask keeps in a sequence of ``seq``,
    under an optional sliding window."""
    if not window or window >= seq:
        return seq * (seq + 1) // 2
    w = window
    return w * (w + 1) // 2 + (seq - w) * w


def matmul_params_per_token(s: dict) -> int:
    """The weights of the products a token passes through: every layer's
    attention projections and its feed-forward (the top-k experts for a
    sparse layer, and the router), and the output table.  The input table
    is a lookup, and norms and biases are no products."""
    D, H, Kv, hd, F, V, L = _sizes(s)
    attn = D * H * hd * 2 + D * Kv * hd * 2
    E = s.get("num_local_experts")
    ffn = 3 * D * F * (s["num_experts_per_tok"] if E else 1)
    router = D * E if E else 0
    return L * (attn + ffn + router) + V * D


def attention_flops_per_token(s: dict, seq: int) -> float:
    """Forward and backward (3x the forward) of QK^T and PV: 4 * hd FLOPs
    a kept pair and head, averaged over the sequence's tokens."""
    D, H, Kv, hd, F, V, L = _sizes(s)
    fwd = 4.0 * H * hd * causal_pairs(seq, s.get("sliding_window")) / seq
    return 3.0 * L * fwd


def model_flops_per_token(s: dict, seq: int) -> float:
    """6 x the product weights + causal attention's forward and backward.
    Recomputation is not counted."""
    return 6.0 * matmul_params_per_token(s) + attention_flops_per_token(s,
                                                                        seq)


def optimizer_bytes(s: dict) -> float:
    """Bytes one round's optimizer steps need over the K clients (one
    local step): each parameter read and written, its gradient read, and
    the state read and written.  AdamW: two f32 moments an element.
    Adafactor: the row and column factors of a leaf of two or more dims,
    a full f32 second moment of a 1-D leaf."""
    total = 0.0
    for shape, dtype, _ in W.leaf_specs(s).values():
        n, item = math.prod(shape), (2 if "16" in str(dtype) else 4)
        b = 2 * n * item + n * item
        if s["optimizer"] == "adamw":
            b += 2 * 2 * n * 4
        elif len(shape) >= 2:
            b += 2 * 4 * (math.prod(shape[:-1])
                          + math.prod(shape[:-2]) * shape[-1])
        else:
            b += 2 * n * 4
        total += b
    return total * s["clients"]


def aggregate_bytes(s: dict, schedule: str) -> float:
    """Bytes one round's aggregation needs: every leaf's K slots read and
    the mean written; under ``compressed`` also the int8 payloads and the
    f32 row scales (one a last-dim row and client) written and read."""
    K = s["clients"]
    total = 0.0
    for shape, dtype, _ in W.leaf_specs(s).values():
        n, item = math.prod(shape), (2 if "16" in str(dtype) else 4)
        total += (K + 1) * n * item
        if schedule == "compressed":
            rows = n // shape[-1]
            total += 2 * K * n + 2 * K * rows * 4
    return total


def flash_fwd_cost(s: dict, batch: int, seq: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one attention forward launch over a layer of one
    client: 4 * hd FLOPs a kept (q, k) pair and head; q, k, v read in
    bf16, o written in bf16 and the f32 row log-sum-exp."""
    D, H, Kv, hd, F, V, L = _sizes(s)
    flops = 4.0 * batch * H * hd * causal_pairs(seq, s.get("sliding_window"))
    nbytes = (2 * batch * seq * H * hd + 2 * batch * seq * Kv * hd) * 2 \
        + batch * H * seq * 4
    return flops, float(nbytes)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / HBM_BYTES_PER_S)
