"""Plain decoder-only language model: the dense (Qwen2) and sparse-expert
(Mixtral) layers, its loss, in float32 and plain PyTorch.

Written from the published descriptions (Qwen2: arXiv:2407.10671, Mixtral:
arXiv:2401.04088), with the federated trainer's conventions where the
papers leave a choice open:

* RMSNorm ``x * rsqrt(mean(x^2) + eps) * scale``; rotary embeddings on the
  two halves of each head (``theta ** (-i / half)``); grouped-query causal
  attention with an optional sliding window; q/k/v biases where the model
  has them; SwiGLU feed-forward; untied input and output tables; the mean
  token cross-entropy.
* The expert layer routes each token to its top-k experts by the f32
  softmax of the router's logits, renormalised over the k; each expert
  keeps at most ``capacity`` assignments, in token order, and drops the
  rest (the trainer's capacity dispatch; Mixtral itself drops none); the
  switch-style auxiliary loss ``coef * E * sum_e f_e * mean_gate_e`` is
  added to the loss.

``precision="fp8"`` computes every matrix product in float8 (the router
excepted, which stays f32 in the trainer too): both inputs in e4m3 with a
per-tensor scale, and in the backward the incoming gradient in e5m2.  That
is the control: the reference one precision step below the bf16 that the
configurations state.

Parameters are a flat dict of f32 tensors keyed by the trainer's leaf
paths (``layers/attn/wq``, ...), one client's, with the stacked layer dim
first.  Nothing here imports the trainer.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_FORWARD = torch.float8_e4m3fn       # products' inputs
FP8_BACKWARD = torch.float8_e5m2        # the gradients flowing into them
CE_ROWS = 2048                          # rows of logits alive at a time


def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` under a per-tensor scale, as f32."""
    if x.numel() == 0:
        return x
    amax = x.abs().amax().clamp_min(1e-30)
    scale = amax / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(torch.float32) * scale


class _FP8MatMul(torch.autograd.Function):
    """a @ b with both inputs in float8 e4m3, and in the backward the
    incoming gradient in float8 e5m2: the usual fp8 training recipe."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a, FP8_FORWARD), _fp8(b, FP8_FORWARD)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, dy):
        qa, qb = ctx.saved_tensors
        qdy = _fp8(dy, FP8_BACKWARD)
        da = qdy @ qb.transpose(-1, -2)
        db = qa.transpose(-1, -2) @ qdy
        # sum over the dims broadcast in the forward
        while da.dim() > qa.dim():
            da = da.sum(0)
        while db.dim() > qb.dim():
            db = db.sum(0)
        return da, db


class Model:
    def __init__(self, sizes: dict, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}: f32 or fp8")
        self.s = sizes
        self.fp8 = precision == "fp8"

    # -- products ------------------------------------------------------
    def mm(self, a, b):
        return _FP8MatMul.apply(a, b) if self.fp8 else a @ b

    # -- pieces ---------------------------------------------------------
    def rmsnorm(self, scale, x):
        var = x.square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.s["rms_norm_eps"]) * scale

    def rope(self, x, positions):
        hd = x.shape[-1]
        half = hd // 2
        freq = 1.0 / (self.s["rope_theta"] ** (
            torch.arange(half, dtype=torch.float32, device=x.device) / half))
        ang = positions[:, None].float() * freq            # (S, half)
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, p, h, positions):
        """h: (B, S, D) -> (B, S, D)."""
        B, S, D = h.shape
        H, Kv, hd = (self.s["num_attention_heads"],
                     self.s["num_key_value_heads"], self.s["head_dim"])
        q = self.mm(h, p["wq"].reshape(D, H * hd)).reshape(B, S, H, hd)
        k = self.mm(h, p["wk"].reshape(D, Kv * hd)).reshape(B, S, Kv, hd)
        v = self.mm(h, p["wv"].reshape(D, Kv * hd)).reshape(B, S, Kv, hd)
        if "bq" in p:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        q, k = self.rope(q, positions), self.rope(k, positions)
        G = H // Kv
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))    # (B, H, S, hd)
        scores = self.mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        ok = positions[:, None] >= positions[None, :]
        window = self.s.get("sliding_window")
        if window:
            ok = ok & (positions[:, None] - positions[None, :] < window)
        scores = scores.masked_fill(~ok, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        o = self.mm(probs, v).transpose(1, 2).reshape(B, S, H * hd)
        return self.mm(o, p["wo"].reshape(H * hd, D))

    def swiglu(self, w_gate, w_up, w_down, x):
        return self.mm(F.silu(self.mm(x, w_gate)) * self.mm(x, w_up), w_down)

    def capacity(self, n_tokens: int) -> int:
        E, k = self.s["num_local_experts"], self.s["num_experts_per_tok"]
        cap = int(self.s["capacity_factor"] * k * n_tokens / E)
        return max(8, ((cap + 7) // 8) * 8)

    def experts(self, p, x):
        """x: (B, S, D) -> (y, aux, dropped assignments)."""
        B, S, D = x.shape
        T = B * S
        E, K = self.s["num_local_experts"], self.s["num_experts_per_tok"]
        xf = x.reshape(T, D)
        gates = torch.softmax(xf @ p["router"], dim=-1)        # f32 router
        topw, topi = torch.topk(gates, K, dim=-1)
        topw = topw / topw.sum(dim=-1, keepdim=True)
        cap = self.capacity(T)
        y = torch.zeros_like(xf)
        dropped = 0
        for e in range(E):
            tok, slot = torch.nonzero(topi == e, as_tuple=True)  # token order
            dropped += max(int(tok.numel()) - cap, 0)
            tok, slot = tok[:cap], slot[:cap]
            out = self.swiglu(p["w_gate"][e], p["w_up"][e], p["w_down"][e],
                              xf[tok])
            y = y.index_add(0, tok, out * topw[tok, slot][:, None])
        counts = torch.bincount(topi.reshape(-1), minlength=E).float()
        f = counts / (T * K)
        aux = self.s["router_aux_loss_coef"] * E * (f * gates.mean(0)).sum()
        return y.reshape(B, S, D), aux, dropped

    # -- the model ------------------------------------------------------
    def loss(self, params, tokens, labels):
        """tokens, labels: (B, S) -> (ce + aux, {"ce", "aux", "dropped"})."""
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)
        x = params["embed/in_table"][tokens.long()]
        aux = torch.zeros((), device=x.device)
        dropped = 0
        moe = "layers/moe/router" in params
        for i in range(self.s["num_hidden_layers"]):
            lp = {name[len("layers/"):].split("/", 1)[1]: t[i]
                  for name, t in params.items()
                  if name.startswith("layers/")}
            h = self.rmsnorm(params["layers/ln1/scale"][i], x)
            x = x + self.attention(lp, h, positions)
            h2 = self.rmsnorm(params["layers/ln2/scale"][i], x)
            if moe:
                y, a, d = self.experts(lp, h2)
                aux, dropped = aux + a, dropped + d
            else:
                y = self.swiglu(lp["w_gate"], lp["w_up"], lp["w_down"], h2)
            x = x + y
        x = self.rmsnorm(params["final_norm/scale"], x).reshape(B * S, -1)
        table, lab = params["embed/out_table"], labels.reshape(-1).long()
        ce = sum(checkpoint(self._ce_sum, x[r0:r0 + CE_ROWS], table,
                            lab[r0:r0 + CE_ROWS], use_reentrant=False)
                 for r0 in range(0, B * S, CE_ROWS)) / (B * S)
        return ce + aux, {"ce": ce, "aux": aux, "dropped": dropped}

    def _ce_sum(self, x, table, labels):
        """The summed cross-entropy of a block of rows: its logits live
        only while the block is worked on, forward and backward."""
        return F.cross_entropy(self.mm(x, table.t()), labels,
                               reduction="sum")
