"""Rank-side helpers of tests/test_torch_tp.py: the module-level functions
``launch.mesh.spawn`` runs on each rank of a (data, model) mesh, and the
numpy-seeded inputs both sides share.  This module imports torch and the
port only (no jax), so a rank starts quickly; it holds no tests."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core import aggregation, fl_step
from repro_torch.core.clustering import build_tree
from repro_torch.core.topology import AggSchedule, compile_tree
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.launch.train import SDFLMQTrainer
from repro_torch.models import model_api

BPC, SEQ = 2, 32            # the trainer's batch per client and sequence
GRAD_SEQ = 80               # above the smoke threshold of 64: flash path


def qwen2_smoke(**kw):
    """qwen2-7b's smoke config: 4 q heads and 2 kv heads (split at M = 2,
    kv whole at M = 4), d_ff 128, vocab 256, QKV bias."""
    return smoke_config(get_arch("qwen2-7b")).replace(**kw)


def numpy_tree(tree):
    return T.tree_map(lambda t: t.detach().float().numpy(), tree)


def blocks_of(tree, specs, mesh, rank=None):
    """Every leaf's block (``local_block``) on ``rank`` of ``mesh``."""
    return T.tree_map(lambda t, s: shd.local_block(t, s, mesh, rank), tree,
                      specs)


def grad_batch(vocab: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (2, GRAD_SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# one client's loss and gradients (a (1, M) mesh), and the vocab-parallel
# pieces
# ---------------------------------------------------------------------------

def client_rank(mesh, params_np, batch_np, remat):
    """This rank's loss and the gradient of its block of every leaf, at
    f32 (``params_np``: the whole client's f32 parameters); then the
    vocab-parallel lookup and cross-entropy on their own inputs."""
    cfg = qwen2_smoke(remat=remat)
    tp = tpar.axis_for(cfg, mesh)
    specs = fl_step.param_specs(cfg, mesh)
    whole = T.tree_map(lambda a: torch.from_numpy(np.array(a)), params_np)
    mine = blocks_of(whole, specs, mesh)
    live = T.tree_map(lambda t: t.clone().requires_grad_(), mine)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    loss, _ = model_api.loss_fn(cfg, live, batch, tp)
    grads = torch.autograd.grad(loss, T.leaves(live))
    out = {"loss": loss.item(), "grads": T.unflatten_like(
        live, [g.numpy() for g in grads])}
    # the vocab-parallel pieces, on inputs of their own
    rng = np.random.default_rng(7)
    V = 256
    table = torch.from_numpy(rng.standard_normal((V, 16)).astype(np.float32))
    logits = torch.from_numpy(
        rng.standard_normal((2, 5, V)).astype(np.float32) * 3)
    ids = torch.from_numpy(rng.integers(0, V, (2, 5)).astype(np.int64))
    rows = V // mesh.shape["model"]
    part = slice(tp.rank * rows, (tp.rank + 1) * rows)
    out["lookup"] = tpar.embed_lookup(table[part], ids, tp).numpy()
    lg = logits[..., part].clone().requires_grad_()
    ce = tpar.cross_entropy(lg, ids, tp)
    out["ce"] = ce.item()
    out["ce_grad"] = torch.autograd.grad(ce, lg)[0].numpy()
    return out


# ---------------------------------------------------------------------------
# aggregate_params over a (data, model) mesh
# ---------------------------------------------------------------------------

# leaf -> (per-client shape, dtype, per-client spec): split on the model
# axis along the last dim (compressed's rows are then the block's), along
# the first, or whole; a scalar, and 49 elements a block (rs_ag pads them)
SHAPES = {"w": ((6, 40), "bfloat16", (None, "model")),
          "r": ((8, 12), "float32", ("model", None)),
          "v": ((5, 3, 24), "float32", (None, None, None)),
          "s": ((), "float32", ()),
          "o": ((7, 14), "float32", (None, "model"))}
KINDS = ("tree", "flat", "rs_ag", "compressed")
STRATEGIES = ("fedavg", "multi_krum")
WEIGHTS = {2: {False: [1.0, 3.0], True: [2.0, 0.0]},
           4: {False: [1.0, 2.0, 3.0, 4.0], True: [1.0, 2.0, 0.0, 3.0]}}
CHUNKS = (aggregation.CHUNK, 64)     # 64: chunked leaves and row blocks
# the (4, 2) case: multi_krum chooses its clients in each model shard
SHARD_SHAPES = {k: SHAPES[k] for k in ("w", "r")}


def spec_of(name: str) -> tuple:
    return ("data",) + SHAPES[name][2]


def agg_case(K: int, seed: int = 0, outliers: bool = False):
    """(bank, ref): f32 numpy leaves (K, *shape) holding exact values of
    each leaf's dtype.  With ``outliers`` (the (4, 2) case), client 1 is
    far off in model shard 0 of each leaf and client 2 in shard 1."""
    rng = np.random.default_rng(seed)
    bank, ref = {}, {}
    shapes = SHARD_SHAPES if outliers else SHAPES
    for name, (shape, dt, spec) in shapes.items():
        scale = (1.0 + np.arange(K)).reshape((K,) + (1,) * len(shape))
        base = rng.standard_normal(shape).astype(np.float32)
        x = base + 0.3 * scale * rng.standard_normal((K,) + shape)
        if outliers:
            dim = spec.index("model")
            half = shape[dim] // 2
            x[(1,) + (slice(None),) * dim + (slice(0, half),)] += 40.0
            x[(2,) + (slice(None),) * dim + (slice(half, None),)] += 40.0
        g = x + 0.2 * scale * rng.standard_normal((K,) + shape)
        cast = getattr(torch, dt)
        bank[name] = torch.from_numpy(x.astype(np.float32)).to(cast) \
            .float().numpy()
        ref[name] = torch.from_numpy(g.astype(np.float32)).to(cast) \
            .float().numpy()
    return bank, ref


def as_port(tree):
    return {k: torch.from_numpy(np.array(v)).to(getattr(torch, SHAPES[k][1]))
            for k, v in tree.items()}


def schedule(kind: str, K: int) -> AggSchedule:
    if kind != "tree":
        return AggSchedule(kind, K)
    clients = [f"c{i}" for i in range(K)]
    return compile_tree(build_tree("s", clients, clients,
                                   aggregator_ratio=0.5, levels=3))


def agg_cases(K: int):
    if K == 4:
        return [("flat", "multi_krum", False)]
    return [(kind, strat, dead) for kind in KINDS for strat in STRATEGIES
            for dead in (False, True)]


def aggregate(bank, ref, kind, strat, dead, mesh=None):
    """The port's ``aggregate_params`` on the whole bank (no mesh) or on
    this rank's block of it -> {leaf: f32 numpy} of the (block of the)
    aggregate in slot 0."""
    K = next(iter(bank.values())).shape[0]
    mine, rin = as_port(bank), as_port(ref)
    if mesh is not None:
        cut = lambda t: {k: shd.local_block(v, spec_of(k), mesh)
                         .contiguous() for k, v in t.items()}
        mine, rin = cut(mine), cut(rin)
    aggregation.aggregate_params(
        mine, torch.tensor(WEIGHTS[K][dead]), schedule(kind, K), strat,
        ref=rin, mesh=mesh)
    return {k: v[0].float().numpy() for k, v in mine.items()}


def agg_rank(mesh):
    """Every ``agg_cases`` case on this rank's block, at each chunk size
    (the (4, 2) mesh: the outlier bank)."""
    K = mesh.shape["data"]
    bank, ref = agg_case(K, outliers=K == 4)
    out = {}
    for chunk in CHUNKS:
        aggregation.CHUNK = chunk
        for case in agg_cases(K):
            out[(chunk,) + case] = aggregate(bank, ref, *case, mesh=mesh)
    return out


# ---------------------------------------------------------------------------
# rounds, init and resume on a (2, 2) mesh
# ---------------------------------------------------------------------------

# (schedule, strategy, rounds): round 0 of the trainer runs at a learning
# rate of 0 (its warmup), so the first update is round 1's
ROUND_CASES = [("tree", "fedavg", 2), ("compressed", "fedavg", 1),
               ("flat", "trimmed_mean", 2)]


def trainer_round(cfg, kind, strat, mesh=None, rounds=1, K=2):
    """One (or ``rounds``) round(s) of the trainer on the CPU, K clients
    (on one device, or on a mesh) -> (metrics, this rank's block of slot 0,
    or slot 0 whole, as numpy)."""
    tr = SDFLMQTrainer(cfg, K, rounds, BPC, SEQ, seed=0, device="cpu",
                       schedule_kind=kind, strategy=strat, mesh=mesh)
    ms = tr.run()
    return ms, numpy_tree(T.tree_map(lambda t: t[0], tr.state["params"]))


class Interrupted(Exception):
    pass


def _trainer(cfg, mesh, rounds, ckpt_dir=None):
    return SDFLMQTrainer(cfg, mesh.shape["data"], rounds, BPC, SEQ, seed=0,
                         device="cpu", mesh=mesh, ckpt_dir=ckpt_dir)


def _state_np(tr):
    return numpy_tree({"params": tr.state["params"],
                       "opt": tr.state["opt"]}), tr.state["step"]


def grid_rank(mesh, ckpt_dir, rounds):
    """On a (2, 2) mesh: this rank's ``init_state`` block; each
    ``ROUND_CASES`` round; a trainer interrupted after round 0 and resumed
    from its checkpoint; an uninterrupted one of ``rounds`` rounds; and the
    aggregation cases."""
    cfg = qwen2_smoke()
    init = fl_step.init_state(cfg, mesh, seed=0, device="cpu")
    out = {"init": numpy_tree({"params": init["params"],
                               "opt": init["opt"]}),
           "rounds": [trainer_round(cfg, kind, strat, mesh=mesh,
                                    rounds=rounds)
                      for kind, strat, rounds in ROUND_CASES]}
    tr = _trainer(cfg, mesh, rounds, ckpt_dir)

    def stop(r, state):
        if r == 0:
            raise Interrupted
    tr.on_round_end = stop
    try:
        tr.run()
    except Interrupted:
        pass
    first = tr.metrics
    tr2 = _trainer(cfg, mesh, rounds, ckpt_dir)
    out["resumed"] = (first, tr2.start_round, tr2.run()) + _state_np(tr2)
    straight = _trainer(cfg, mesh, rounds)
    out["straight"] = (straight.run(),) + _state_np(straight)
    out["agg"] = agg_rank(mesh)
    return out
