"""Rank-side helpers of tests/test_torch_moe_tp.py: the module-level functions
``launch.mesh.spawn`` runs on each rank of a (data, model) mesh, and the
numpy-seeded inputs both sides share.  This module imports torch and the
port only (no jax), so a rank starts quickly; it holds no tests."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core import aggregation, fl_step
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.launch.train import SDFLMQTrainer
from repro_torch.models import model_api, moe
from repro_torch.optim.api import adafactor, constant

import test_torch_tp_ranks as R

BPC, SEQ = R.BPC, R.SEQ
GRAD_SEQ = R.GRAD_SEQ       # above the smoke threshold of 64: flash path


def replica(cfg, **kw):
    return cfg.replace(fl=cfg.fl.__class__(mode="replica"), **kw)


def moe_smoke(name: str, **kw):
    """The MoE smoke configs in ``replica`` mode, under Adafactor:
    ``ep`` mixtral-8x22b's (4 experts: expert parallelism at M = 2 and 4),
    ``tp3`` the same with 3 experts (they do not divide 2: intra-expert
    tensor parallelism over d_ff_expert 32), ``kimi`` kimi-k2's (a dense
    first layer of d_ff 64, one shared expert, 4 experts)."""
    arch = "kimi-k2-1t-a32b" if name == "kimi" else "mixtral-8x22b"
    cfg = replica(smoke_config(get_arch(arch)), **kw)
    if name == "tp3":
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=3))
    return cfg


FORMS = ("ep", "tp3", "kimi")


def layer_input(cfg, seed: int = 3):
    """(B, S, D) f32 input of one MoE layer."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, GRAD_SEQ, cfg.d_model)).astype(np.float32)


def layer_params(params_np):
    """One MoE layer's parameters: layer 0 of the stacked MoE layers."""
    return T.tree_map(lambda a: np.array(a[0]), params_np["layers"]["moe"])


def layer_specs(cfg, M: int):
    """The specs of one MoE layer's leaves on a (1, M) mesh."""
    specs = fl_step.param_specs(cfg, {"data": 1, "model": M})
    return T.tree_map(lambda s: s[1:], specs["layers"]["moe"])


def moe_layer(cfg, p, x, tp=None):
    """-> (y, aux, the layer's gradients, dx, the routing statistics) of
    ``moe.moe_apply`` on ``x`` (numpy), the loss ``sum(y * cot) + aux``."""
    live = T.tree_map(lambda t: t.clone().requires_grad_(), p)
    xt = torch.from_numpy(x).requires_grad_()
    moe.reset_stats()
    y, aux = moe.moe_apply(cfg, live, xt, tp)
    stats = moe.read_stats()
    cot = torch.from_numpy(np.random.default_rng(4).standard_normal(
        y.shape).astype(np.float32))
    grads = torch.autograd.grad((y * cot).sum() + aux,
                                [xt] + T.leaves(live))
    return {"y": y.detach().numpy(), "aux": aux.item(), "dx": grads[0].numpy(),
            "grads": T.unflatten_like(live, [g.numpy() for g in grads[1:]]),
            "stats": stats}


def client_loss(cfg, params, batch, tp=None):
    """-> (loss, every leaf's gradient, the routing statistics) of
    ``model_api.loss_fn``."""
    live = T.tree_map(lambda t: t.clone().requires_grad_(), params)
    moe.reset_stats()
    loss, _ = model_api.loss_fn(cfg, live, {
        k: torch.from_numpy(v) for k, v in batch.items()}, tp)
    grads = torch.autograd.grad(loss, T.leaves(live))
    return loss.item(), T.unflatten_like(
        live, [g.numpy() for g in grads]), moe.read_stats()


def whole(tree_np):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)), tree_np)


def client_rank(mesh, cases, remat):
    """For each (form, f32 client parameters, batch) of ``cases``: this
    rank's loss, the gradient of its block of every leaf and the routing
    statistics; and one MoE layer alone on a seeded input (its output,
    auxiliary loss, gradients and statistics)."""
    out = {}
    for name, params_np, batch in cases:
        cfg = moe_smoke(name, remat=remat)
        tp = tpar.axis_for(cfg, mesh)
        specs = fl_step.param_specs(cfg, mesh)
        mine = R.blocks_of(whole(params_np), specs, mesh)
        loss, grads, stats = client_loss(cfg, mine, batch, tp)
        lspecs = layer_specs(cfg, mesh.shape["model"])
        lp = R.blocks_of(whole(layer_params(params_np)), lspecs, mesh)
        out[name] = {"loss": loss, "grads": grads, "stats": stats,
                     "form": tpar.moe_split(cfg, tp.size),
                     "layer": moe_layer(cfg, lp, layer_input(cfg), tp)}
    return out


# ---------------------------------------------------------------------------
# Adafactor on blocks
# ---------------------------------------------------------------------------

# name -> (whole shape, the per-leaf spec on a (1, 2) mesh): the last dim
# split, the second-to-last, a leading expert dim, a 1-D leaf, and a leaf
# whole on every rank
ADAFACTOR_LEAVES = {
    "last": ((3, 6, 8), (None, None, "model")),
    "second": ((3, 8, 6), (None, "model", None)),
    "experts": ((2, 4, 6, 8), (None, "model", None, None)),
    "vector": ((10,), ("model",)),
    "whole": ((6, 5), (None, None)),
}
ADAFACTOR_STEPS, ADAFACTOR_LR = 2, 0.05


def adafactor_case(seed: int = 11, leaves=None):
    """(params, [grads per step]) as f32 numpy trees of ``leaves`` (name
    -> (shape, spec); ``ADAFACTOR_LEAVES`` by default)."""
    leaves = leaves or ADAFACTOR_LEAVES
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, (s, _) in leaves.items()}
    grads = [{k: (rng.standard_normal(s) * (1 + np.arange(s[-1]))).astype(
        np.float32) for k, (s, _) in leaves.items()}
        for _ in range(ADAFACTOR_STEPS)]
    return params, grads


def adafactor_run(params_np, grads_np, cut=None, **axes):
    """``ADAFACTOR_STEPS`` Adafactor updates (each applied) -> (the
    updates of each step, the final factors), as numpy; ``cut`` maps a
    whole tensor to this rank's block, and ``axes`` are ``adafactor``'s
    (``tp``/``split``, ``dp``/``data_split``)."""
    cut = cut or (lambda k, t: t)
    take = lambda tree: {k: cut(k, torch.from_numpy(v)).clone()
                         for k, v in tree.items()}
    opt = adafactor(constant(ADAFACTOR_LR), **axes)
    params = take(params_np)
    state = opt.init(params)
    updates = []
    for step, g in enumerate(grads_np):
        u, state = opt.update(take(g), state, params, step)
        for k in params:
            params[k].add_(u[k])
        updates.append({k: v.numpy() for k, v in u.items()})
    return updates, T.tree_map(lambda t: t.numpy(), state["f"])


def adafactor_rank(mesh):
    params, grads = adafactor_case()
    tp = tpar.GroupAxis(mesh.group("model"), mesh.shape["model"],
                        mesh.coord("model"))
    split = {k: tuple(i for i, a in enumerate(s) if a == "model")
             for k, (_, s) in ADAFACTOR_LEAVES.items()}
    cut = lambda k, t: shd.local_block(t, ADAFACTOR_LEAVES[k][1], mesh)
    return adafactor_run(params, grads, cut, tp=tp, split=split)


def rank_one(mesh, cases, remat):
    """Everything a (1, M) mesh runs: the clients, and at M = 2 the
    Adafactor blocks."""
    out = {"clients": client_rank(mesh, cases, remat)}
    if mesh.shape["model"] == 2:
        out["adafactor"] = adafactor_rank(mesh)
    return out


# ---------------------------------------------------------------------------
# aggregate_params of MoE leaves over a (2, 2) mesh
# ---------------------------------------------------------------------------

# leaf -> (per-client shape, dtype, per-client spec): expert parallelism's
# leaves (4 experts split), the router's columns, intra-expert tensor
# parallelism's (3 experts whole, their width split on the last or the
# second-to-last dim), and a whole expert-bias-like leaf
SHAPES = {"w_gate": ((4, 6, 10), "bfloat16", ("model", None, None)),
          "w_down": ((4, 10, 6), "bfloat16", ("model", None, None)),
          "router": ((6, 4), "float32", (None, "model")),
          "tp_up": ((3, 6, 10), "bfloat16", (None, None, "model")),
          "tp_down": ((3, 10, 6), "bfloat16", (None, "model", None)),
          "norm": ((6,), "float32", (None,))}
KINDS = R.KINDS
STRATEGIES = ("fedavg", "trimmed_mean", "multi_krum")
WEIGHTS = R.WEIGHTS


def spec_of(name: str) -> tuple:
    return ("data",) + SHAPES[name][2]


def agg_case(K: int, seed: int = 5):
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
    this rank's block of it -> {leaf: f32 numpy} of slot 0's (block)."""
    K = next(iter(bank.values())).shape[0]
    port = lambda t: {k: torch.from_numpy(np.array(v)).to(
        getattr(torch, SHAPES[k][1])) for k, v in t.items()}
    mine, rin = port(bank), port(ref)
    if mesh is not None:
        cut = lambda t: {k: shd.local_block(v, spec_of(k), mesh)
                         .contiguous() for k, v in t.items()}
        mine, rin = cut(mine), cut(rin)
    aggregation.aggregate_params(
        mine, torch.tensor(WEIGHTS[K][False]), R.schedule(kind, K), strat,
        ref=rin, mesh=mesh)
    return {k: v[0].float().numpy() for k, v in mine.items()}


def agg_rank(mesh):
    bank, ref = agg_case(mesh.shape["data"])
    out = {}
    for chunk in R.CHUNKS:
        aggregation.CHUNK = chunk
        for case in agg_cases():
            out[(chunk,) + case] = aggregate(bank, ref, *case, mesh=mesh)
    return out


# ---------------------------------------------------------------------------
# rounds and resume on a (2, 2) mesh, under Adafactor
# ---------------------------------------------------------------------------

ROUND_CASES = [("ep", "tree", "fedavg", 2),
               ("kimi", "compressed", "fedavg", 1),
               ("tp3", "flat", "multi_krum", 2)]


def trainer_round(cfg, kind, strat, mesh=None, rounds=1, K=2):
    """The trainer's ``rounds`` rounds on the CPU, K clients (one device,
    or a mesh) -> (metrics, this rank's block of slot 0, or slot 0 whole,
    as numpy)."""
    tr = SDFLMQTrainer(cfg, K, rounds, BPC, SEQ, seed=0, device="cpu",
                       schedule_kind=kind, strategy=strat, mesh=mesh)
    moe.reset_stats()
    ms = tr.run()
    return ms, R.numpy_tree(T.tree_map(lambda t: t[0], tr.state["params"])), \
        moe.read_stats()


def _trainer(cfg, mesh, rounds, ckpt_dir=None):
    return SDFLMQTrainer(cfg, mesh.shape["data"], rounds, BPC, SEQ, seed=0,
                         device="cpu", mesh=mesh, ckpt_dir=ckpt_dir)


def _state_np(tr):
    return R.numpy_tree({"params": tr.state["params"],
                         "opt": tr.state["opt"]}), tr.state["step"]


def grid_rank(mesh, ckpt_dir, rounds):
    """On a (2, 2) mesh, all under Adafactor: each ``ROUND_CASES`` round;
    an ``ep`` trainer interrupted after round 0 and resumed from its
    checkpoint, and an uninterrupted one; and the aggregation cases."""
    out = {"rounds": [trainer_round(moe_smoke(name), kind, strat, mesh=mesh,
                                    rounds=n)
                      for name, kind, strat, n in ROUND_CASES]}
    cfg = moe_smoke("ep")
    tr = _trainer(cfg, mesh, rounds, ckpt_dir)

    def stop(r, state):
        if r == 0:
            raise R.Interrupted
    tr.on_round_end = stop
    try:
        tr.run()
    except R.Interrupted:
        pass
    first = tr.metrics
    tr2 = _trainer(cfg, mesh, rounds, ckpt_dir)
    out["resumed"] = (first, tr2.start_round, tr2.run()) + _state_np(tr2)
    straight = _trainer(cfg, mesh, rounds)
    out["straight"] = (straight.run(),) + _state_np(straight)
    out["agg"] = agg_rank(mesh)
    return out
