"""Rank-side helpers of tests/test_torch_shared.py: the module-level
functions ``launch.mesh.spawn`` runs on each rank of a (pod, data, model)
mesh in ``shared`` mode, and the numpy-seeded inputs both sides share.
This module imports torch and the port only (no jax), so a rank starts
quickly; it holds no tests."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core import aggregation, fl_step
from repro_torch.dist import fsdp
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.launch.train import SDFLMQTrainer
from repro_torch.models import inputs, model_api, moe

import test_torch_moe_tp_ranks as MR
import test_torch_tp_ranks as R

BPC, SEQ = R.BPC, R.SEQ
GRAD_SEQ = R.GRAD_SEQ       # above the smoke threshold of 64: flash path
# the MoE client's capacity factor: capacity(160 tokens) = 40 a expert of
# the 80 assignments each gets on average, so assignments are dropped; a
# data rank routing its own 80 tokens alone would take a capacity of 24
CAPACITY_FACTOR = 0.5


def shared(cfg, **kw):
    return cfg.replace(fl=cfg.fl.__class__(mode="shared"), **kw)


def dense_smoke(**kw):
    """qwen2-7b's smoke config in ``shared`` mode: d_model 64 (its embed
    dim, split over the data ranks), 4 q and 2 kv heads."""
    return shared(smoke_config(get_arch("qwen2-7b")), **kw)


def moe_smoke(**kw):
    """mixtral-8x22b's smoke config in ``shared`` mode (its declared mode),
    under Adafactor: 4 experts (split at M = 2), d_model 64, window 32."""
    return shared(smoke_config(get_arch("mixtral-8x22b")), **kw)


def binding(cfg):
    """``cfg`` with ``CAPACITY_FACTOR``: a capacity that drops."""
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=CAPACITY_FACTOR))


def client_cfg(name: str):
    return dense_smoke() if name == "dense" else binding(moe_smoke())


def whole(tree_np):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)), tree_np)


# ---------------------------------------------------------------------------
# (c) one client over its data ranks, a (1, 2, 1) mesh
# ---------------------------------------------------------------------------

def client_loss(cfg, mesh, params_np, batch_np):
    """This rank's loss, the gradient of its block of every leaf and the
    routing statistics at f32, on its rows of ``batch_np`` (the client's
    whole batch)."""
    dp = fl_step.data_axis_for(cfg, mesh)
    tp = tpar.axis_for(cfg, mesh)
    specs = fl_step.param_specs(cfg, mesh)
    live = T.tree_map(lambda t: t.clone().requires_grad_(),
                      R.blocks_of(whole(params_np), specs, mesh))
    batch, split = inputs.rank_rows(
        {k: torch.from_numpy(v) for k, v in batch_np.items()}, dp.size,
        dp.rank)
    dp = dp.with_split(split)
    moe.reset_stats()
    loss, parts = model_api.loss_fn(cfg, live, batch, tp, dp)
    grads = list(torch.autograd.grad(loss, T.leaves(live)))
    grads = fsdp.reduce_replicated(
        grads, fl_step.leaf_path_names(live), dp)
    return {"loss": loss.item(), "aux": parts["aux"].item(),
            "split": dp.split, "stats": moe.read_stats(),
            "grads": T.unflatten_like(live, [g.numpy() for g in grads])}


def client_loss_single(cfg, params_np, batch_np):
    """The single device's loss, auxiliary loss and routing statistics of
    the client's whole batch at f32."""
    moe.reset_stats()
    with torch.no_grad():
        loss, parts = model_api.loss_fn(cfg, whole(params_np), {
            k: torch.from_numpy(v) for k, v in batch_np.items()})
    return {"loss": loss.item(), "aux": parts["aux"].item(),
            "stats": moe.read_stats()}


def k1_round(cfg, mesh=None, rounds=1):
    """``rounds`` rounds of the trainer, K = 1, batch ``BPC`` of one row
    (``BPC`` 1: the batch does not split over 2 data ranks) -> (losses,
    the state as numpy)."""
    tr = SDFLMQTrainer(cfg, 1, rounds, 1, SEQ, seed=0, device="cpu",
                       mesh=mesh)
    ms = tr.run()
    return [m["loss"] for m in ms], R.numpy_tree(
        {"params": tr.state["params"], "opt": tr.state["opt"]})


# ---------------------------------------------------------------------------
# Adafactor on (data, model) blocks
# ---------------------------------------------------------------------------

# name -> (whole shape, spec): split on ``data`` along the last dim, the
# second-to-last, an expert leaf (experts on ``model``, ``embed`` on
# ``data``), a 1-D leaf, both axes (a dense ``w_gate``'s (embed, mlp) and
# ``w_down``'s (mlp, embed)), and whole on every rank.  A dim on ``model``
# is whole on a model axis of 1.
ADAFACTOR_LEAVES = {
    "last": ((3, 6, 8), (None, None, "data")),
    "second": ((3, 8, 6), (None, "data", None)),
    "experts": ((2, 4, 8, 6), (None, "model", "data", None)),
    "vector": ((10,), ("data",)),
    "gate": ((3, 8, 6), (None, "data", "model")),
    "down": ((3, 6, 8), (None, "model", "data")),
    "whole": ((6, 5), (None, None)),
}


def adafactor_rank(mesh):
    """``MR.ADAFACTOR_STEPS`` Adafactor updates of this rank's block of
    each ``ADAFACTOR_LEAVES`` leaf, with the mesh's data axis (and its
    model axis above 1) -> (updates of each step, final factors)."""
    params, grads = MR.adafactor_case(leaves=ADAFACTOR_LEAVES)
    dims = lambda ax: {k: tuple(i for i, a in enumerate(s) if a == ax)
                       for k, (_, s) in ADAFACTOR_LEAVES.items()}
    axes = {"dp": fsdp.DataAxis(mesh.group("data"), mesh.shape["data"],
                                mesh.coord("data"), {}),
            "data_split": dims("data")}
    if mesh.shape["model"] > 1:
        axes |= {"tp": tpar.GroupAxis(mesh.group("model"),
                                      mesh.shape["model"],
                                      mesh.coord("model")),
                 "split": dims("model")}
    cut = lambda k, t: shd.local_block(t, ADAFACTOR_LEAVES[k][1], mesh)
    return MR.adafactor_run(params, grads, cut, **axes)


def client_rank(mesh, cases):
    """On a (1, 2, 1) mesh: each (name, f32 parameters, batch) case's
    loss and gradients, a batch-1 AdamW round with the single-device
    K = 1 round beside it (run on this rank, at its thread count), and
    the Adafactor blocks."""
    out = {name: client_loss(client_cfg(name), mesh, params, batch)
           for name, params, batch in cases}
    out["adafactor"] = adafactor_rank(mesh)
    cfg = dense_smoke(optimizer="adamw")
    out["k1"] = k1_round(cfg, mesh)
    out["k1_single"] = k1_round(cfg)
    out["agg_k1"] = {kind: aggregate(*agg_case(1), kind, "fedavg", mesh=mesh)
                     for kind in KINDS}
    return out


# ---------------------------------------------------------------------------
# (d) rounds at f32 against the single device
# ---------------------------------------------------------------------------

# (config, optimizer, schedule) on a (2, 2, 1) mesh, K = 2 clients of 2
# data ranks, batch 2 a client (split), two rounds (round 0 at a learning
# rate of 0, the warmup)
ROUND_CASES = [("dense", opt, kind) for opt in ("adamw", "adafactor")
               for kind in ("tree", "flat", "compressed")]
ROUNDS = 2
LR = 3e-4           # the warmup's peak, round 1's rate at 2 rounds


def kimi_smoke(**kw):
    """kimi-k2's smoke config in ``shared`` mode: a dense first layer, one
    shared expert and 4 routed experts."""
    return shared(smoke_config(get_arch("kimi-k2-1t-a32b")), **kw)


def round_cfg(name: str, opt: str):
    cfg = {"dense": dense_smoke, "moe": moe_smoke, "kimi": kimi_smoke}[name]()
    return cfg.replace(optimizer=opt)


def f32_state(cfg, n, seed: int = 0):
    """``init_state`` (K clients, or a mesh) with f32 parameters and
    optimizer state."""
    st = fl_step.init_state(cfg, n, seed, "cpu", total_steps=ROUNDS)
    f32 = lambda t: t.float() if torch.is_tensor(t) else t
    return {"params": T.tree_map(f32, st["params"]),
            "opt": T.tree_map(f32, st["opt"]), "step": 0}


def batches(K: int, vocab: int):
    """The clients' batches of each round, (K, BPC, SEQ) numpy."""
    rng = np.random.default_rng(9)
    out = []
    for _ in range(ROUNDS):
        toks = rng.integers(0, vocab, (K, BPC, SEQ + 1)).astype(np.int32)
        out.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    return out


WEIGHTS = np.array([3.0, 5.0], np.float32)


def by_block(cfg, sizes):
    """A single-device ``aggregate_params`` that aggregates each leaf of a
    client-stacked bank per (data, model) block of a mesh of ``sizes``,
    as that mesh's ranks do: under ``compressed`` each quantizes its
    block's rows."""
    specs = [(None,) + s[1:]
             for s in T.leaves(fl_step.param_specs(cfg, sizes))]
    grid = {ax: n for ax, n in sizes.items() if ax != "pod"}
    at = [shd.mesh_coords(grid, r) for r in range(int(np.prod(
        list(grid.values()))))]

    def agg(bank, weights, schedule, strategy, ref=None, mesh=None,
            axis=None):
        refs = None if ref is None else T.leaves(ref)
        for j, (t, s) in enumerate(zip(T.leaves(bank), specs)):
            for r, c in enumerate(at):      # each block once
                if any(c[ax] for ax in grid if ax not in s):
                    continue
                cut = lambda x: shd.local_block(x, s, grid, r)
                block = {"x": cut(t).clone()}
                aggregation.aggregate_params(
                    block, weights, schedule, strategy,
                    ref=None if refs is None else {"x": cut(refs[j]).clone()})
                cut(t).copy_(block["x"])
        return bank
    return agg


def f32_rounds(cfg, kind, K, mesh=None, blocks=None, make=None):
    """``ROUNDS`` f32 rounds of the round step under ``kind``, K clients on
    one device or this rank's on ``mesh`` -> (losses, state as numpy).
    ``blocks`` (one device): aggregate per block of a mesh of these sizes
    (``by_block``).  ``make(K, vocab)``: the rounds' batches, by default
    ``batches``'."""
    st = f32_state(cfg, mesh or K)
    sched = R.schedule(kind, K) if K > 1 else R.schedule("flat", 1)
    step = fl_step.build_fl_round_step(cfg, mesh or K, sched, "cpu",
                                       total_steps=ROUNDS)
    who = 0
    if mesh is not None and K > 1:
        who = mesh.coord(fl_step.client_axis_for(cfg, mesh))
    losses = []
    whole_agg = fl_step.aggregate_params
    if blocks is not None:
        fl_step.aggregate_params = by_block(cfg, blocks)
    try:
        for b in (make or batches)(K, cfg.vocab):
            if mesh is not None or K == 1:
                b = {k: v[who] for k, v in b.items()}
            st, m = step(st, b, WEIGHTS[:K])
            losses.append(float(m["loss"]))
    finally:
        fl_step.aggregate_params = whole_agg
    return losses, R.numpy_tree({"params": st["params"], "opt": st["opt"]})


def grid_rank(mesh, ckpt_dir):
    """On a (2, 2, 1) mesh: each ``ROUND_CASES`` case; an Adafactor trainer
    interrupted after round 0 and resumed, and an uninterrupted one; and
    the aggregation cases."""
    out = {"rounds": [f32_rounds(round_cfg(name, opt), kind, 2, mesh)
                      for name, opt, kind in ROUND_CASES]}
    cfg = moe_smoke()
    tr = _trainer(cfg, mesh, ckpt_dir)

    def stop(r, state):
        if r == 0:
            raise R.Interrupted
    tr.on_round_end = stop
    try:
        tr.run()
    except R.Interrupted:
        pass
    first = tr.metrics
    tr2 = _trainer(cfg, mesh, ckpt_dir)
    out["resumed"] = (first, tr2.start_round, tr2.run()) + _state_np(tr2)
    straight = _trainer(cfg, mesh)
    out["straight"] = (straight.run(),) + _state_np(straight)
    out["agg"] = agg_rank(mesh)
    return out


MOE_NAMES = ("moe", "kimi")


def moe_rank(mesh):
    """On a (1, 2, 2) mesh: each MoE config's f32 rounds, K = 1 (experts on
    ``model``, ``embed`` on ``data``, batch 2 split), and the Adafactor
    blocks."""
    out = {name: f32_rounds(round_cfg(name, "adafactor"), "flat", 1, mesh)
           for name in MOE_NAMES}
    out["adafactor"] = adafactor_rank(mesh)
    return out


def _trainer(cfg, mesh, ckpt_dir=None):
    return SDFLMQTrainer(cfg, mesh.shape["pod"], ROUNDS, BPC, SEQ, seed=0,
                         device="cpu", mesh=mesh, ckpt_dir=ckpt_dir)


def _state_np(tr):
    return R.numpy_tree({"params": tr.state["params"],
                         "opt": tr.state["opt"]}), tr.state["step"]


# ---------------------------------------------------------------------------
# (b) aggregate_params across pods, on (data) blocks
# ---------------------------------------------------------------------------

# leaf -> (per-client shape, dtype, per-client spec on a (2, 2, 1) mesh):
# split on ``data`` along the last dim (compressed's rows are then the
# block's), along the first, or whole; a scalar
SHAPES = {"w": ((6, 40), "bfloat16", (None, "data")),
          "r": ((8, 12), "float32", ("data", None)),
          "v": ((5, 3, 24), "float32", (None, None, None)),
          "s": ((), "float32", ()),
          "o": ((7, 14), "float32", (None, "data"))}
KINDS = ("tree", "flat", "rs_ag", "compressed")
STRATEGIES = ("fedavg", "fedprox", "trimmed_mean", "multi_krum")
AGG_WEIGHTS = [1.0, 3.0]


def spec_of(name: str) -> tuple:
    return ("pod",) + SHAPES[name][2]


def agg_case(K: int = 2, seed: int = 3):
    """(bank, ref): f32 numpy leaves (K, *shape) holding exact values of
    each leaf's dtype."""
    rng = np.random.default_rng(seed)
    bank, ref = {}, {}
    for name, (shape, dt, _) in SHAPES.items():
        scale = (1.0 + np.arange(K)).reshape((K,) + (1,) * len(shape))
        base = rng.standard_normal(shape).astype(np.float32)
        x = base + 0.3 * scale * rng.standard_normal((K,) + shape)
        g = x + 0.2 * scale * rng.standard_normal((K,) + shape)
        cast = getattr(torch, dt)
        bank[name] = torch.from_numpy(x.astype(np.float32)).to(cast) \
            .float().numpy()
        ref[name] = torch.from_numpy(g.astype(np.float32)).to(cast) \
            .float().numpy()
    return bank, ref


def agg_cases():
    return [(kind, strat) for kind in KINDS for strat in STRATEGIES]


def aggregate(bank, ref, kind, strat, mesh=None):
    """The port's ``aggregate_params`` on the whole bank (no mesh) or on
    this rank's block of it across the pods -> {leaf: f32 numpy} of slot
    0's (block)."""
    K = next(iter(bank.values())).shape[0]
    port = lambda t: {k: torch.from_numpy(np.array(v)).to(
        getattr(torch, SHAPES[k][1])) for k, v in t.items()}
    mine, rin = port(bank), port(ref)
    if mesh is not None:
        cut = lambda t: {k: shd.local_block(v, spec_of(k), mesh)
                         .contiguous() for k, v in t.items()}
        mine, rin = cut(mine), cut(rin)
    aggregation.aggregate_params(
        mine, torch.tensor(AGG_WEIGHTS[:K]), R.schedule(kind, K), strat,
        ref=rin, mesh=mesh, axis="pod")
    return {k: v[0].float().numpy() for k, v in mine.items()}


def agg_rank(mesh):
    bank, ref = agg_case(mesh.shape["pod"])
    out = {}
    for chunk in R.CHUNKS:
        aggregation.CHUNK = chunk
        for case in agg_cases():
            out[(chunk,) + case] = aggregate(bank, ref, *case, mesh=mesh)
    aggregation.CHUNK = R.CHUNKS[0]
    return out
