"""Rank-side helpers of tests/test_torch_dist.py: the module-level
functions ``launch.mesh.spawn`` runs on each rank, and the numpy-seeded
inputs both sides share.  This module imports torch and the port only (no
jax), so a rank starts quickly; it holds no tests."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config
from repro_torch.core import aggregation, fl_step
from repro_torch.core.clustering import build_tree
from repro_torch.core.topology import AggSchedule, compile_tree
from repro_torch.ft.failures import FailurePlan
from repro_torch.launch.train import SDFLMQTrainer
from repro_torch.models import inputs

K = 4
# leaf -> (per-client shape, dtype): a bf16 matrix, an f32 3-D leaf, a
# scalar (an all-reduce below 4 x world elements under rs_ag) and 91
# elements (rs_ag pads them to 92)
SHAPES = {"w": ((6, 40), "bfloat16"), "v": ((5, 3, 24), "float32"),
          "s": ((), "float32"), "o": ((7, 13), "float32")}
KINDS = ("tree", "flat", "rs_ag", "compressed")
STRATEGIES = ("fedavg", "fedprox", "trimmed_mean", "coordinate_median",
              "multi_krum")
STACK = STRATEGIES[2:]               # the per-coordinate (stack) combines
WEIGHTS = {False: [1.0, 2.0, 3.0, 4.0], True: [1.0, 2.0, 0.0, 3.0]}
CHUNKS = (aggregation.CHUNK, 64)     # 64: chunked leaves and row blocks


def agg_case(seed: int = 0):
    """(bank, ref): f32 numpy leaves (K, *shape) holding exact values of
    each leaf's dtype.  Client k's rows spread with k, so krum's distances
    are well separated; each client's ref is near its own row."""
    rng = np.random.default_rng(seed)
    bank, ref = {}, {}
    for name, (shape, dt) in SHAPES.items():
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


def as_port(tree, rows=slice(None)):
    return {k: torch.from_numpy(np.array(v[rows])).to(
        getattr(torch, SHAPES[k][1])) for k, v in tree.items()}


def tree_schedule() -> AggSchedule:
    """The reference's test tree: ``build_tree(..., 0.5, 3)`` over K
    clients, compiled into level groups."""
    clients = [f"c{i}" for i in range(K)]
    return compile_tree(build_tree("s", clients, clients,
                                   aggregator_ratio=0.5, levels=3))


def schedule(kind: str) -> AggSchedule:
    return tree_schedule() if kind == "tree" else AggSchedule(kind, K)


def agg_cases():
    return [(kind, strat, dead) for kind in KINDS for strat in STRATEGIES
            for dead in (False, True)]


def aggregate(bank, ref, kind, strat, dead, mesh=None):
    """The port's ``aggregate_params`` on the whole bank (no mesh) or on
    this rank's slot -> {leaf: f32 numpy} of the rank's (or slot 0's)
    aggregate."""
    rows = slice(None) if mesh is None else slice(mesh.rank, mesh.rank + 1)
    mine = as_port(bank, rows)
    aggregation.aggregate_params(
        mine, torch.tensor(WEIGHTS[dead]), schedule(kind), strat,
        ref=as_port(ref, rows), mesh=mesh)
    return {k: v[0].float().numpy() for k, v in mine.items()}


def agg_rank(mesh, chunks=CHUNKS):
    """Every ``agg_cases`` case on this rank's slot, at each chunk size."""
    bank, ref = agg_case()
    out = {}
    for chunk in chunks:
        aggregation.CHUNK = chunk
        for case in agg_cases():
            out[(chunk,) + case] = aggregate(bank, ref, *case, mesh=mesh)
    return out


# ---------------------------------------------------------------------------
# rounds
# ---------------------------------------------------------------------------

ROUND_CASES = [("tree", "fedavg", {}), ("flat", "fedavg", {}),
               ("rs_ag", "fedavg", {}), ("compressed", "fedavg", {}),
               ("tree", "fedprox", {}),
               ("tree", "trimmed_mean", {0: ["c3"]}),
               ("tree", "multi_krum", {0: ["c3"]})]
BPC, SEQ = 2, 32


def qwen2_smoke():
    return smoke_config(get_arch("qwen2-7b"))


def adafactor_smoke():
    """mixtral-8x22b's smoke config (Adafactor) in ``replica`` mode, one
    client a rank (its own config's ``shared`` mode, one client a pod, is
    tests/test_torch_shared.py's)."""
    cfg = smoke_config(get_arch("mixtral-8x22b"))
    return cfg.replace(fl=dataclasses.replace(cfg.fl, mode="replica"))


def numpy_tree(tree):
    return T.tree_map(lambda t: t.detach().float().numpy(), tree)


def trainer_round(cfg, kind, strat, fail, mesh=None, rounds=1):
    """One (or ``rounds``) round(s) of the trainer on the CPU, K clients
    (on one device, or one a rank) -> (metrics, the params of this rank's
    slot, or of slot 0, as numpy)."""
    tr = SDFLMQTrainer(cfg, K, rounds, BPC, SEQ, seed=0, device="cpu",
                       schedule_kind=kind, strategy=strat, mesh=mesh,
                       failure_plan=FailurePlan(fail_at=dict(fail)))
    ms = tr.run()
    return ms, numpy_tree(T.tree_map(lambda t: t[0], tr.state["params"]))


def round_rank(mesh):
    """This rank's initial state, then each ``ROUND_CASES`` round."""
    cfg = qwen2_smoke()
    init = fl_step.init_state(cfg, mesh, seed=0, device="cpu")
    moe = adafactor_smoke()                              # Adafactor's state
    ada = fl_step.init_state(moe, mesh, seed=3, device="cpu")
    return {"init": numpy_tree({"params": init["params"],
                                "opt": init["opt"]}),
            "adafactor": numpy_tree({"params": ada["params"],
                                     "opt": ada["opt"]}),
            "rounds": [trainer_round(cfg, *case, mesh=mesh)
                       for case in ROUND_CASES]}


def schedules_rank(mesh, arch, kinds):
    """The reference's multi-device smokes on the ranks: one round step
    of each schedule from the same state, batch and weights 1..K
    (``ShapeConfig("t", 32, 8, "train")``, the batch's row for this rank).
    -> {kind: (loss, this rank's slot as numpy)}, and the abstract state's
    leaf count."""
    cfg = smoke_config(get_arch(arch))
    shape = ShapeConfig("t", 32, 8, "train")
    batch = {k: v[mesh.rank] for k, v in inputs.make_batch(
        cfg, shape, 0, clients=K, device="cpu").items()}
    out = {}
    for kind in kinds:
        state = fl_step.init_state(cfg, mesh, seed=0, device="cpu")
        step = fl_step.build_fl_round_step(cfg, mesh, schedule(kind),
                                           device="cpu")
        state, m = step(state, batch, np.arange(1.0, K + 1.0))
        out[kind] = (float(m["loss"]), numpy_tree(
            T.tree_map(lambda t: t[0], state["params"])))
    n_abstract = len(T.leaves(fl_step.abstract_state(cfg, mesh)["params"]))
    return out, n_abstract


class Interrupted(Exception):
    pass


def resume_rank(mesh, ckpt_dir, arch, rounds, fail, stop_after=None):
    """A trainer with a checkpoint directory: interrupted after round
    ``stop_after`` when given (the checkpoint of that round is written),
    then a second trainer on the same directory that resumes and runs to
    ``rounds``.  -> (first run's metrics, start_round, second run's
    metrics, the final state of this rank as numpy)."""
    cfg = smoke_config(get_arch(arch))
    plan = FailurePlan(fail_at=dict(fail))
    tr = SDFLMQTrainer(cfg, mesh.world, rounds, BPC, SEQ, seed=0,
                       device="cpu", mesh=mesh, ckpt_dir=ckpt_dir,
                       failure_plan=plan)
    if stop_after is not None:
        def stop(r, state):
            if r == stop_after:
                raise Interrupted
        tr.on_round_end = stop
    try:
        first = tr.run()
    except Interrupted:
        first = tr.metrics
    tr2 = SDFLMQTrainer(cfg, mesh.world, rounds, BPC, SEQ, seed=0,
                        device="cpu", mesh=mesh, ckpt_dir=ckpt_dir,
                        failure_plan=plan)
    start = tr2.start_round
    second = tr2.run()
    return first, start, second, numpy_tree(
        {"params": tr2.state["params"], "opt": tr2.state["opt"]}), \
        tr2.state["step"]


def split_resume_rank(mesh, leaf_max, *args):
    """``resume_rank`` with the checkpoint's part limit lowered to
    ``leaf_max`` bytes in this rank's process, so that rank 0 writes the
    gathered state's larger leaves as parts."""
    from repro_torch.ckpt import checkpoint
    checkpoint.LEAF_BYTES_MAX = leaf_max
    return resume_rank(mesh, *args)


def straight_rank(mesh, arch, rounds, fail):
    """An uninterrupted run of ``rounds`` rounds -> (metrics, final state
    of this rank as numpy, step)."""
    cfg = smoke_config(get_arch(arch))
    tr = SDFLMQTrainer(cfg, mesh.world, rounds, BPC, SEQ, seed=0,
                       device="cpu", mesh=mesh,
                       failure_plan=FailurePlan(fail_at=dict(fail)))
    ms = tr.run()
    return ms, numpy_tree({"params": tr.state["params"],
                           "opt": tr.state["opt"]}), tr.state["step"]


def failing_rank(mesh, bad_rank):
    if mesh.rank == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    torch.distributed.barrier()
    return mesh.rank


def sleeping_rank(mesh, seconds):
    import time
    time.sleep(seconds)
    return mesh.rank
