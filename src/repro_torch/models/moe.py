"""Mixture-of-Experts FFN with capacity-based token dispatch (plain PyTorch).

Token-choice top-k routing; assignments are sorted by expert (stable, so
within an expert in token order), written into fixed (E, capacity, D)
buffers (overflow dropped: standard capacity dropping) and the expert FFNs
run as dense batched products (``torch.bmm``), as the reference computes
them outside any Pallas kernel.

The reference's ``impl`` variants (``ep_a2a``, ``tp_local``) differ only in
the sharding constraints pinned on the dispatch buffers
(``repro_torch/dist/moe_a2a.py``).  Here a ``tp``
(``dist.tensor_parallel.ModelAxis``) splits the layer over the client's
model ranks in the form the expert leaves' specs give it
(``tensor_parallel.moe_split``): expert parallelism, or intra-expert
tensor parallelism, or the whole layer on every rank where neither the
experts nor their width divide the axis; the shared expert is a
``swiglu`` on the ``mlp`` axis, split or whole by its own width.
A ``dp`` (``dist.fsdp.DataAxis``, the ``shared`` mode) whose batch is split
over the client's data ranks gathers the rows of every rank first, so the
layer routes and dispatches the client's whole batch (its capacity and
auxiliary loss are the whole batch's, as the reference's), and keeps the
rank's own rows of the output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import fsdp
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.dist.sharding import decl
from repro_torch.models.layers import swiglu, swiglu_decl


# Routing statistics of the calls since ``reset_stats``: the number of
# calls, and summed over them as 0-d tensors on the calls' device (no
# synchronization) the assignments dropped at capacity and the auxiliary
# loss.  A call counts as its last step; under remat the backward's
# recompute stops at the last tensor it needs, before that step, so each
# layer forward counts once.
calls = 0
dropped = 0
aux_sum = 0.0


def reset_stats():
    global calls, dropped, aux_sum
    calls, dropped, aux_sum = 0, 0, 0.0


def read_stats() -> dict:
    """-> {"calls", "dropped", "aux_mean"} as Python numbers (waits for the
    device)."""
    return {"calls": calls, "dropped": int(dropped),
            "aux_mean": float(aux_sum) / calls if calls else None}


def _count(valid: torch.Tensor, aux: torch.Tensor):
    global calls, dropped, aux_sum
    calls += 1
    dropped = dropped + (~valid).sum()
    aux_sum = aux_sum + aux.detach()


def moe_decl(cfg: ArchConfig):
    m = cfg.moe
    d = {
        "router": decl((cfg.d_model, m.n_experts), ("embed", "experts"),
                       dtype=torch.float32, scale=0.5),
        "w_gate": decl((m.n_experts, cfg.d_model, m.d_ff_expert),
                       ("experts", "embed", "expert_mlp")),
        "w_up": decl((m.n_experts, cfg.d_model, m.d_ff_expert),
                     ("experts", "embed", "expert_mlp")),
        "w_down": decl((m.n_experts, m.d_ff_expert, cfg.d_model),
                       ("experts", "expert_mlp", "embed")),
    }
    if m.n_shared_experts:
        d["shared"] = swiglu_decl(cfg.d_model,
                                  m.n_shared_experts * m.d_ff_expert)
    return d


def capacity(n_tokens: int, m) -> int:
    cap = int(m.capacity_factor * m.top_k * n_tokens / m.n_experts)
    return max(8, ((cap + 7) // 8) * 8)


def route(router_w, x_flat, top_k: int):
    """x_flat: (T, D) -> (weights (T,k), ids (T,k), gates (T,E)), in f32."""
    logits = x_flat.float() @ router_w
    gates = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(gates, top_k, dim=-1)
    topw = topw / topw.sum(dim=-1, keepdim=True)
    return topw, topi, gates


def moe_apply(cfg: ArchConfig, p, x, tp=None, dp=None):
    """x: (B, S, D) -> (y: (B, S, D), aux_loss: scalar)."""
    m = cfg.moe
    if m.impl == "ep_a2a":
        from repro_torch.dist.moe_a2a import moe_apply_a2a
        return moe_apply_a2a(cfg, p, x, tp, dp)
    if m.impl == "tp_local":
        from repro_torch.dist.moe_a2a import moe_apply_tp_local
        return moe_apply_tp_local(cfg, p, x, tp, dp)
    return moe_apply_dense(cfg, p, x, tp, dp)


def dispatch(ids: torch.Tensor, n_experts: int, cap: int):
    """ids: (T, k) expert ids -> (order, slot, valid) over the T*k
    assignments sorted by expert (stable: token order within an expert).
    ``slot`` is the row of (E * cap) an assignment is written to, and
    ``E * cap`` (one spare row) where it is dropped at capacity."""
    N = ids.numel()
    flat = ids.reshape(N)
    order = torch.argsort(flat, stable=True)
    sid = flat[order]
    first = torch.searchsorted(sid, sid, right=False)
    rank = torch.arange(N, device=ids.device) - first   # position in expert
    valid = rank < cap
    slot = torch.where(valid, sid * cap + rank,
                       torch.full_like(sid, n_experts * cap))
    return order, slot, valid


def moe_apply_dense(cfg: ArchConfig, p, x, tp=None, dp=None):
    """The capacity-dispatch path.  The return scatter-add sums each
    token's k contributions in increasing expert id, one rounding in x's
    dtype per add, from zero: the order of the sorted assignments, in
    which the reference's scatter-add runs on the CPU, and the same order
    on the card.

    With ``tp`` the expert leaves are this rank's blocks.  Expert
    parallelism (``moe_split`` gives ``"experts"``): the router's columns
    are gathered whole, every rank routes and dispatches all T tokens into
    the whole buffer, runs its own E/M experts' rows, and gathers every
    expert's output before the combine, so the forward is the single
    device's.  Intra-expert tensor parallelism (``"expert_mlp"``): each
    expert's FFN is column- then row-parallel over its width.  Either way
    only the dispatch's input goes through ``copy_to_model`` (its gradient
    covers this rank's experts or width); the router's path to x is whole
    on every rank.  Where neither divides the axis (``moe_split`` gives
    None) every rank runs the whole layer on its whole leaves, as one
    device does.  The shared expert splits or stays whole by its own width
    (``swiglu``'s ``shared`` block).

    With ``dp`` and a split batch, x is this rank's rows: the layer runs on
    every data rank's rows gathered (``fsdp.gather_rows``), and the rank
    keeps its own rows of the routed output; the shared expert runs on its
    own rows alone."""
    m = cfg.moe
    own = x
    if dp is not None and dp.split:
        x = fsdp.gather_rows(x, dp)
    B, S, D = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    xf = x.reshape(T, D)
    form = None if tp is None else tp.blocks["moe"]

    router = p["router"] if form != "experts" else \
        tpar.gather_from_model(p["router"], tp, -1)
    topw, topi, gates = route(router, xf, K)

    cap = capacity(T, m)
    order, slot, valid = dispatch(topi, E, cap)
    tok = torch.arange(T, device=x.device).repeat_interleave(K)
    stok, sw = tok[order], topw.reshape(T * K)[order]

    # rows of dropped assignments land in the spare row, sliced away
    xd = xf if form is None else tpar.copy_to_model(xf, tp)
    buf = x.new_zeros((E * cap + 1, D)).index_put((slot,), xd[stok])
    h = buf[:E * cap].reshape(E, cap, D)
    if form == "experts":           # this rank's experts' rows
        h = h.narrow(0, tp.rank * (E // tp.size), E // tp.size)
    g = torch.bmm(h, p["w_gate"])
    up = torch.bmm(h, p["w_up"])
    act = F.silu(g.float()).to(x.dtype) * up
    if form == "expert_mlp":
        out = tpar.row_parallel(act, p["w_down"], tp)
    else:
        out = torch.bmm(act, p["w_down"])
    if form == "experts":
        out = tpar.gather_from_model(out, tp, 0)
    out = out.reshape(E * cap, D)

    gathered = out[slot.clamp(0, E * cap - 1)]
    gathered = torch.where(valid[:, None], gathered, gathered.new_zeros(()))
    contrib = gathered * sw[:, None].to(x.dtype)
    # each token's k contributions, in increasing expert id: the position
    # of assignment (t, choice) in the sorted order, choices by id
    where = torch.argsort(order).reshape(T, K)
    where = where.gather(1, torch.argsort(topi, dim=-1))
    per_tok = contrib[where]                            # (T, K, D)
    y = x.new_zeros((T, D))
    for j in range(K):
        y = y + per_tok[:, j]
    if own is not x:                                    # this rank's rows
        y = fsdp.own_rows(y.view(B, S, D), dp).reshape(-1, D)

    # Switch-style load-balancing auxiliary loss.
    n = torch.full((), T * K, dtype=torch.float32, device=x.device)
    # each expert's assignments (``bincount``'s counts, as a scatter-add,
    # which the meta device runs too: a dry run traces this layer)
    idx = topi.reshape(-1)
    f = torch.zeros(E, dtype=torch.int64, device=x.device).scatter_add_(
        0, idx, torch.ones_like(idx)).float() / n
    pmean = gates.mean(dim=0)
    aux = m.aux_coef * E * (f * pmean).sum()

    if m.n_shared_experts:
        y = y + swiglu(p["shared"], own.reshape(-1, D), tp, "shared")
    _count(valid, aux)
    return y.reshape(own.shape), aux
