"""Dry run of every (arch x shape) cell on the reference's production
meshes, with no card: what one rank holds, and what bounds its step.

    python -m repro_torch.launch.dryrun --all --both-meshes
    python -m repro_torch.launch.report --dir experiments/dryrun_torch

The reference lowers one SPMD program for 256 or 512 placeholder devices
and reads XLA's memory and cost analyses of it.  Here one process starts a
``fake`` process group of N ranks (N = 256 for (data 16, model 16), 512
for (pod 2, data 16, model 16)), builds the port's own ``launch.mesh.Mesh``
on the meta device as rank 0, and runs the port's real round step, prefill
or decode step once on meta tensors: the code that runs on the card, with
nothing allocated and nothing launched.  The hand-written kernels' wrappers
give meta outputs of their kernels' shapes and report each call's
``cost()``.  Two trackers watch the step (``launch/op_analysis.py``):
``OpCounter``, the counterpart of the HLO analysis (FLOPs, eager HBM
bytes, collectives' wire bytes by the ring rule, kernel calls), and
``LiveBytes``, the counterpart of ``memory_analysis()`` (the bytes alive,
from the step's inputs to its peak).  Rank 0 is the rank a ``tree``
schedule makes the head of every level, so it is the most loaded rank;
every number in a record is rank 0's.

Each record keeps the reference's keys (``arch, shape, mesh, status,
n_devices, schedule, moe_impl, params_total, params_active, tokens,
memory, roofline``); ``trace_s`` takes the place of ``lower_s`` and
``compile_s``, ``kernels`` lists each kernel's calls, FLOPs and bytes, and
``op_cost`` is the whole ``OpCost`` (each op's calls among it).
``memory`` keeps ``memory_analysis()``'s keys: the arguments are the
state, batch and weights the rank holds (serving: its parameter blocks,
cache and batch), the output and its alias what the step updates in
place (the train state, the decode cache; a prefill's new cache is
temp), temp the peak beyond the arguments, and ``total_per_device`` the
peak; ``params_bytes``, ``state_bytes`` (train) and ``cache_bytes``
(serving) are parts of the arguments.  ``lower_cell`` also takes a ``ShapeConfig`` and a ``mesh_shape``,
for cells at shapes a card runs (the reference's ``make_host_mesh``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.configs.base import (SHAPES, ShapeConfig, get_arch,
                                      list_archs, shape_applicable)
from repro_torch.core import fl_step
from repro_torch.core.clustering import build_tree
from repro_torch.core.topology import AggSchedule, compile_tree, flat_schedule
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import Mesh, production_shape
from repro_torch.launch.op_analysis import LiveBytes, OpCounter
from repro_torch.launch.roofline import build_roofline, model_flops
from repro_torch.models import inputs as minputs
from repro_torch.models import kvcache as kvc
from repro_torch.models import model_api
from repro_torch.serve.engine import ServeEngine

META = torch.device("meta")


# --------------------------------------------------------------------------
# Parameter accounting
# --------------------------------------------------------------------------

def param_counts(cfg):
    """(total, active) parameter counts; active discounts routed experts."""
    decls = model_api.param_decls(cfg)
    total = shd.param_count(decls)
    if cfg.moe is None:
        return total, total
    expert_n = sum(d.size for d in T.leaves(decls) if "experts" in d.axes)
    frac = cfg.moe.top_k / cfg.moe.n_experts
    active = total - expert_n + expert_n * frac
    return total, int(active)


# --------------------------------------------------------------------------
# A rank's inputs, on the meta device
# --------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _blocks(decls, specs, mesh):
    """Rank ``mesh.rank``'s block of every leaf of ``decls`` under
    ``specs``, each a meta tensor of its own."""
    return T.tree_map(lambda d, s: _meta(shd.local_block(
        _meta(d.shape, d.dtype), s, mesh).shape, d.dtype), decls, specs)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in T.leaves(tree)
               if torch.is_tensor(t))


def input_specs(cfg, shape, mesh):
    """The rank's inputs for one cell, as meta tensors.  Train: its state
    (``fl_step.abstract_state``), its client's batch (``models/inputs``;
    every rank of a client gets the whole of it) and the K weights.
    Serving: its parameter blocks (``model_api.serve_specs``), the batch
    (prefill: the prompts on the host, as the engine takes them; decode:
    the last tokens), and for decode its cache block
    (``kvcache.cache_specs``) of ``cache_len_for(seq_len)`` slots."""
    if shape.kind == "train":
        n = fl_step.n_clients_for(cfg, mesh)
        batch = minputs.batch_struct(cfg, shape, n if n > 1 else 0)
        lead = 1 if n > 1 else 0        # the rank's client's slot
        return {"state": fl_step.abstract_state(cfg, mesh),
                "batch": {k: _meta(v.shape[lead:], v.dtype)
                          for k, v in batch.items()},
                "weights": _meta((max(n, 1),), torch.float32)}
    params = _blocks(model_api.param_decls(cfg),
                     model_api.serve_specs(cfg, mesh), mesh)
    B = shape.global_batch
    if shape.kind == "prefill":
        return {"params": params,
                "prompts": np.zeros((B, shape.seq_len), np.int32)}
    clen = model_api.cache_len_for(cfg, shape.seq_len)
    decls = model_api.get_model(cfg).cache_decl(cfg, B, max(clen, 1))
    cache = _blocks(decls, kvc.cache_specs(cfg, decls, mesh), mesh)
    return {"params": params, "cache": cache,
            "token": _meta((B,), torch.int32)}


# --------------------------------------------------------------------------
# Cell tracing
# --------------------------------------------------------------------------

def make_schedule(cfg, mesh, kind=None):
    n = fl_step.n_clients_for(cfg, mesh)
    kind = kind or cfg.fl.schedule
    if n <= 1:
        return flat_schedule(max(n, 1))
    if kind == "tree":
        clients = [f"c{i}" for i in range(n)]
        tree = build_tree("dryrun", clients, clients,
                          cfg.fl.aggregator_ratio, cfg.fl.levels)
        return compile_tree(tree)
    return AggSchedule(kind, n)


def fake_mesh(shape: dict, rank: int = 0) -> Mesh:
    """``rank``'s ``Mesh`` of ``shape`` on the meta device, over a ``fake``
    process group of every rank in this process (no communication; its
    collectives take meta tensors).  Raises where a process group exists."""
    if dist.is_initialized():
        raise RuntimeError("a dry run starts its own process group; this "
                           "process already has one")
    # registers the ``fake`` backend where the build does not have it
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    world = math.prod(shape.values())
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank,
                            world_size=world)
    return Mesh(rank, world, META, "fake", model=shape["model"],
                pods=shape.get("pod", 0))


def _trace_train(cfg, mesh, specs, schedule):
    step = fl_step.build_fl_round_step(
        cfg, mesh, make_schedule(cfg, mesh, schedule))
    with LiveBytes(specs) as live, OpCounter() as oc:
        step(specs["state"], specs["batch"], specs["weights"])
    return live, oc


def _trace_serve(cfg, mesh, specs, shape):
    engine = ServeEngine(cfg, specs["params"], shape.global_batch,
                         shape.seq_len, mesh=mesh)
    B = shape.global_batch
    with LiveBytes(specs) as live, OpCounter() as oc:
        if shape.kind == "prefill":
            # the engine's prefill of B prompts of seq_len tokens, its
            # cache sized to them (no new tokens)
            engine.prefill(specs["prompts"], 0)
        else:
            engine.plan(B, model_api.cache_len_for(cfg, shape.seq_len))
            rows = engine.rows(B)
            engine.decode(specs["cache"], specs["token"][rows],
                          shape.seq_len - 1)
    return live, oc


def _record(arch_name, shape, multi_pod, **extra):
    return {"arch": arch_name, "shape": shape.name,
            "mesh": "multipod" if multi_pod else "pod", **extra}


def lower_cell(arch_name: str, shape_name, multi_pod: bool,
               schedule: str = None, moe_impl: str = None,
               overrides: dict = None,
               mesh_shape: dict = None):
    """Traces one cell on rank 0 of its mesh (module docstring) -> its
    record.  ``shape_name`` is a name in ``SHAPES`` or a ``ShapeConfig``;
    ``mesh_shape`` a mesh's ``{"pod"?, "data", "model"}`` in place of the
    production mesh.  The step updates its state (or cache) in place, so
    its output is an alias of its inputs.  The fake process group is this
    call's and is destroyed when it returns."""
    cfg = get_arch(arch_name)
    if moe_impl and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, impl=moe_impl))
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = shape_name if isinstance(shape_name, ShapeConfig) \
        else SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return _record(arch_name, shape, multi_pod, status="skipped",
                       reason=why)
    sizes = dict(mesh_shape or production_shape(multi_pod))
    t0 = time.time()
    mesh = fake_mesh(sizes)
    try:
        specs = input_specs(cfg, shape, mesh)
        if shape.kind == "train":
            live, oc = _trace_train(cfg, mesh, specs, schedule)
        else:
            live, oc = _trace_serve(cfg, mesh, specs, shape)
    finally:
        dist.destroy_process_group()
    trace_s = time.time() - t0

    # what the step updates in place: the train state, the decode cache
    if shape.kind == "train":
        params = specs["state"]["params"]
        updated = {k: specs["state"][k] for k in ("params", "opt")}
    else:
        params, updated = specs["params"], specs.get("cache", {})
    out = _nbytes(updated)
    mem = {"argument_size_in_bytes": live.arguments,
           "output_size_in_bytes": out,
           "temp_size_in_bytes": live.peak - live.arguments,
           "alias_size_in_bytes": out,
           "generated_code_size_in_bytes": 0}
    mem["total_per_device"] = (mem["argument_size_in_bytes"]
                               + mem["output_size_in_bytes"]
                               + mem["temp_size_in_bytes"]
                               - mem["alias_size_in_bytes"])
    mem["params_bytes"] = _nbytes(params)
    mem["state_bytes" if shape.kind == "train" else "cache_bytes"] = out

    total_p, active_p = param_counts(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        mf = model_flops(active_p, tokens, "train")
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mf = model_flops(active_p, tokens, "serve")
    else:
        tokens = shape.global_batch
        mf = model_flops(active_p, tokens, "serve")

    n_dev = math.prod(sizes.values())
    rf = build_roofline(oc.cost, n_dev, mf)
    return _record(
        arch_name, shape, multi_pod, status="ok", n_devices=n_dev,
        mesh_shape=sizes, schedule=schedule or cfg.fl.schedule,
        moe_impl=cfg.moe.impl if cfg.moe else None,
        params_total=total_p, params_active=active_p,
        params_per_rank=sum(t.numel() for t in T.leaves(params)),
        tokens=tokens, trace_s=round(trace_s, 1), memory=mem,
        roofline=rf.to_dict(), kernels=oc.cost.kernels,
        op_cost=oc.cost.to_dict())


# --------------------------------------------------------------------------

def cell_list():
    cells = []
    for a in list_archs():
        for s in SHAPES:
            cells.append((a, s))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--schedule", default=None,
                    choices=[None, "tree", "flat", "rs_ag", "compressed"])
    ap.add_argument("--moe-impl", default=None,
                    choices=[None, "auto", "ep_a2a", "tp_local"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    if args.all:
        cells = cell_list()
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multipod]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'multipod' if mp else 'pod'}"
            if args.schedule:
                tag += f"__{args.schedule}"
            if args.moe_impl:
                tag += f"__{args.moe_impl}"
            path = os.path.join(args.out, tag + ".json")
            try:
                rec = lower_cell(arch, shape, mp, args.schedule,
                                 moe_impl=args.moe_impl)
            except Exception as e:
                failures += 1
                rec = {"arch": arch, "shape": shape,
                       "mesh": "multipod" if mp else "pod",
                       "status": "error", "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            st = rec["status"]
            extra = ""
            if st == "ok":
                r = rec["roofline"]
                extra = (f" dom={r['dominant']} comp={r['compute_s']:.4f}s"
                         f" mem={r['memory_s']:.4f}s coll={r['collective_s']:.4f}s"
                         f" frac={r['roofline_fraction']:.3f}"
                         f" bytes/dev={rec['memory']['total_per_device'] / 2**30:.2f}GiB"
                         f" trace={rec['trace_s']}s")
            elif st == "error":
                extra = " " + rec["error"][:160]
            else:
                extra = " " + rec["reason"][:80]
            print(f"[{st:7s}] {tag}{extra}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
