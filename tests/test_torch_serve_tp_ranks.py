"""Rank-side helpers of tests/test_torch_serve_tp.py: the configs and
serving cases both sides share, and the module-level functions
``launch.mesh.spawn`` runs on each rank of a (data, model) mesh.  This
module imports torch and the port only (no jax), so a rank starts
quickly; it holds no tests."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.dist import sharding as shd
from repro_torch.models import kvcache as kvc
from repro_torch.models import model_api
from repro_torch.serve.engine import ServeEngine

ARCHS = {"qwen2": "qwen2-7b", "qwen2_window": "qwen2-7b",
         "mixtral": "mixtral-8x22b", "rwkv": "rwkv6-7b",
         "hymba": "hymba-1.5b", "hymba_whole": "hymba-1.5b"}
# qwen2-7b's smoke config with a window of 32 (ROADMAP R4: the engine
# leaves a windowed cache unpadded), and Hymba with hymba-1.5b's shape on
# a model axis of 2 or 4: 5 q and 5 kv heads, neither of which divides
OVERRIDES = {"qwen2_window": {"window": 32},
             "hymba_whole": {"n_heads": 5, "n_kv_heads": 5}}
MAX_NEW = 3

# mesh -> its cases: (name, prompt lengths of one batch, the cache layout
# a rank holds).  The smoke configs have 4 q and 2 kv heads (rwkv6: 4
# heads of 16) and a window of 32 (hymba, mixtral).  A full-attention cache
# has S + MAX_NEW + 1 slots (S the longest prompt), a windowed decoder's S
# (R4), Hymba's min(32, S) (R3 where 32 does not divide S); it splits on
# its sequence where that divides M, else on its kv heads where 2 divides
# M, else stays whole.
CASES = {
    (1, 2): [("qwen2", (28, 20, 28, 9), "seq"),
             ("qwen2", (29, 7, 29, 29), "heads"),
             ("qwen2_window", (12, 12, 5, 12), "seq"),
             ("rwkv", (27, 15, 27, 3), None),
             ("hymba", (40, 33, 40, 40), "seq"),
             ("hymba", (31, 31, 12, 31), "heads"),
             ("hymba_whole", (40, 40, 26, 40), "seq"),
             ("hymba_whole", (31, 31, 31, 4), "whole")],
    (1, 4): [("qwen2", (28, 28, 11, 28), "seq"),
             ("qwen2", (29, 29, 29, 16), "whole"),
             ("qwen2", (4, 4, 2, 4), "seq"),        # blocks with no valid slot
             ("rwkv", (27, 27, 9, 27), None),
             ("hymba", (40, 40, 40, 17), "seq"),
             ("hymba", (30, 30, 30, 30), "whole"),
             ("hymba_whole", (64, 64, 50, 64), "seq")],
    (2, 2): [("qwen2", (28, 28, 13, 28), "seq"),
             ("qwen2", (29, 10, 29, 29), "heads"),
             ("mixtral", (28, 28, 28, 19), "seq"),
             ("mixtral", (27, 27, 27, 27), "heads"),
             ("mixtral", (20, 20, 20), "seq"),      # 3 rows: not split on data
             ("rwkv", (27, 27, 27, 27), None),
             ("hymba", (40, 40, 21, 40), "seq")],
}


def config(name: str):
    """The smoke config of case ``name``, in its declared mode (mixtral's
    ``shared``: its parameters split on ``data`` too)."""
    return smoke_config(get_arch(ARCHS[name])).replace(
        **OVERRIDES.get(name, {}))


def case_inputs(vocab: int, lens, seed: int):
    """(the prompts, their left-padded batch (B, S), the teacher-forced
    tokens (B, MAX_NEW)) of one case, from a numpy seed."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, p in enumerate(prompts):
        toks[i, toks.shape[1] - len(p):] = p
    forced = rng.integers(0, vocab, (len(lens), MAX_NEW)).astype(np.int32)
    return prompts, toks, forced


def whole_params(params_np):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)), params_np)


def serve(cfg, params, lens, seed, mesh=None, engine_cls=ServeEngine):
    """One case through ``ServeEngine`` (or ``engine_cls``; one device, or
    this rank's blocks of ``params`` on ``mesh``): prefill, MAX_NEW decode
    steps on the teacher-forced tokens, then the prompts' greedy tokens
    from ``run``.  -> the rank's rows, its logits (prefill, then each
    step), the cache layouts and leaf shapes, the greedy tokens."""
    if mesh is not None:
        specs = model_api.serve_specs(cfg, mesh)
        params = T.tree_map(lambda t, s: shd.local_block(t, s, mesh),
                            params, specs)
    engine = engine_cls(cfg, params, batch_size=len(lens), device="cpu",
                        mesh=mesh)
    prompts, toks, forced = case_inputs(cfg.vocab, lens, seed)
    rows = engine.rows(len(lens))
    logits, cache = engine.prefill(toks, MAX_NEW)
    out = [logits.float().numpy()]
    for j in range(MAX_NEW):
        out.append(engine.decode(cache, torch.from_numpy(forced[rows, j]),
                                 toks.shape[1] + j).float().numpy())
    shapes = {k: tuple(v.shape) for k, v in cache.items()}
    layout, cross_layout = engine.layout, engine.cross_layout
    for p in prompts:
        engine.submit(p, MAX_NEW)
    done = engine.run()
    return {"rows": (rows.start, rows.stop), "logits": out,
            "layout": layout, "cross_layout": cross_layout,
            "shapes": shapes, "tokens": [r.out for r in done]}


def serve_rank(mesh, cases, params_np):
    """Every case of this mesh on this rank (``params_np``: name -> the
    whole f32 parameters); with the specs of each case's cache, for the
    shapes' check."""
    out = []
    for i, (name, lens, _) in enumerate(cases):
        cfg = config(name)
        res = serve(cfg, whole_params(params_np[name]), lens, seed=i,
                    mesh=mesh)
        decls = model_api.get_model(cfg).cache_decl(
            cfg, len(lens), max(kvc.serve_cache_len(
                cfg, max(lens), MAX_NEW, 256), 1))
        res["specs"] = kvc.cache_specs(cfg, decls, mesh)
        res["decl_shapes"] = T.tree_map(lambda d: d.shape, decls)
        out.append(res)
    return out


def world1_rank(mesh, names, config_of=config, serve_of=serve):
    """On a (1, 1) mesh: each config's parameters from a seed through
    ``init_params(..., mesh=)`` against the plain ``init_params``, and its
    engine's logits and tokens against the plain engine's, bit for bit
    (``config_of`` and ``serve_of``: this module's ``config`` and ``serve``
    or another's)."""
    out = []
    for name in names:
        cfg = config_of(name)
        blocks = model_api.init_params(cfg, 3, "cpu", mesh=mesh)
        plain = model_api.init_params(cfg, 3, "cpu")
        same = all(torch.equal(a, b) for a, b in zip(T.leaves(blocks),
                                                     T.leaves(plain)))
        lens = (30, 12, 30, 30)
        got = serve_of(cfg, blocks, lens, seed=5, mesh=mesh)
        want = serve_of(cfg, plain, lens, seed=5)
        out.append({"params_equal": same,
                    "logits_equal": all(np.array_equal(a, b) for a, b in zip(
                        got["logits"], want["logits"])),
                    "tokens": (got["tokens"], want["tokens"])})
    return out
