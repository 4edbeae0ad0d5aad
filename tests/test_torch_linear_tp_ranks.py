"""Rank-side helpers of tests/test_torch_linear_tp.py: the module-level
functions ``launch.mesh.spawn`` runs on each rank of a (data, model) or
(pod, data, model) mesh for RWKV6 and Hymba, and the configs both sides
share.  This module imports torch and the port only (no jax), so a rank
starts quickly; it holds no tests."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core import fl_step
from repro_torch.dist import fsdp
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.launch.train import SDFLMQTrainer
from repro_torch.models import inputs, model_api

import test_torch_shared_ranks as S
import test_torch_tp_ranks as R

BPC, SEQ = R.BPC, R.SEQ
# above 2 x the smoke configs' rwkv_chunk of 8 (the WKV carries its state
# across chunks) and above their attention threshold of 64 (flash path)
GRAD_SEQ = R.GRAD_SEQ

ARCHS = {"rwkv": "rwkv6-7b", "hymba": "hymba-1.5b",
         "hymba_whole": "hymba-1.5b", "qwen_whole": "qwen2-7b"}
# the smoke configs' own head counts, and the variants whose heads stay
# whole on the model axis: hymba-1.5b's shape at M = 2 or 4 (5 q and 5 kv
# heads: neither divides), and a dense config whose 6 q heads (2 kv) do not
# divide 4
HEADS = {"hymba_whole": {"n_heads": 5, "n_kv_heads": 5},
         "qwen_whole": {"n_heads": 6}}


def config(name: str, mode: str = "replica", **kw):
    """The smoke config of case ``name`` in ``mode``: ``rwkv`` (rwkv6-7b:
    4 heads of 16, d_ff 128), ``hymba`` (4 q and 2 kv heads: split at
    M = 2, kv whole at M = 4), ``hymba_whole`` and ``qwen_whole`` (heads
    whole, ``HEADS``)."""
    cfg = smoke_config(get_arch(ARCHS[name])).replace(**HEADS.get(name, {}))
    return cfg.replace(fl=cfg.fl.__class__(mode=mode), **kw)


# ---------------------------------------------------------------------------
# (b), (c), (e) one client's loss and gradients
# ---------------------------------------------------------------------------

# mesh -> the client cases spawned on it: (name, mode, remat)
CLIENT_CASES = {(1, 2): [("rwkv", "replica", False),
                         ("hymba", "replica", False),
                         ("hymba_whole", "replica", False)],
                (1, 4): [("rwkv", "replica", True),
                         ("hymba", "replica", True),
                         ("qwen_whole", "replica", False)],
                (1, 2, 2): [("rwkv", "shared", False),
                            ("hymba", "shared", False)]}


def client_loss(cfg, mesh, params_np, batch_np):
    """This rank's loss, the gradient of its block of every leaf at f32,
    and the shapes and layout of every WKV call's inputs."""
    tp = tpar.axis_for(cfg, mesh)
    dp = fl_step.data_axis_for(cfg, mesh)
    specs = fl_step.param_specs(cfg, mesh)
    live = T.tree_map(lambda t: t.clone().requires_grad_(),
                      R.blocks_of(S.whole(params_np), specs, mesh))
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    if dp is not None:
        batch, split = inputs.rank_rows(batch, dp.size, dp.rank)
        dp = dp.with_split(split)
    calls, real = [], wkv_ops.wkv_f32

    def spy(r, k, v, w_log, u=None, s0=None, chunk=wkv_ops.DEFAULT_CHUNK):
        calls.append({"r": tuple(r.shape), "w": tuple(w_log.shape),
                      "w_contiguous": w_log.is_contiguous(),
                      "u": None if u is None else tuple(u.shape)})
        return real(r, k, v, w_log, u=u, s0=s0, chunk=chunk)
    wkv_ops.wkv_f32 = spy
    try:
        loss, _ = model_api.loss_fn(cfg, live, batch, tp, dp)
    finally:
        wkv_ops.wkv_f32 = real
    grads = list(torch.autograd.grad(loss, T.leaves(live)))
    if dp is not None:
        grads = fsdp.reduce_replicated(
            grads, fl_step.leaf_path_names(live), dp)
    return {"loss": loss.item(), "wkv": calls,
            "heads_split": None if tp is None else tp.blocks["heads"],
            "grads": T.unflatten_like(live, [g.numpy() for g in grads])}


def client_rank(mesh, cases):
    """Each (name, mode, remat, f32 parameters, batch) case's loss and
    gradients on this rank."""
    return {name: client_loss(config(name, mode, remat=remat), mesh, params,
                              batch)
            for name, mode, remat, params, batch in cases}


# ---------------------------------------------------------------------------
# (d), (f) rounds and resume
# ---------------------------------------------------------------------------

# (case, optimizer, schedule) on a (2, 2) mesh in replica mode, K = 2
# clients of 2 model ranks, and on a (2, 2, 1) mesh in shared mode, K = 2
# pods of 2 data ranks (batch 2 split); two rounds, round 0 at a learning
# rate of 0 (the warmup)
ROUND_CASES = ([("rwkv", opt, kind) for opt in ("adamw", "adafactor")
                for kind in ("tree", "flat", "compressed")]
               + [("hymba", "adamw", "tree"), ("hymba_whole", "adamw", "tree")])
SHARED_ROUND_CASES = [("rwkv", "adamw", "tree"), ("hymba", "adamw", "tree")]


def round_cfg(name: str, opt: str, mode: str = "replica"):
    return config(name, mode, optimizer=opt)


def _trainer(cfg, mesh, ckpt_dir=None):
    return SDFLMQTrainer(cfg, mesh.shape["data"], S.ROUNDS, BPC, SEQ,
                         seed=0, device="cpu", mesh=mesh, ckpt_dir=ckpt_dir)


def resume_cfg():
    """The resume case: rwkv6's smoke config under Adafactor."""
    return round_cfg("rwkv", "adafactor")


def grid_rank(mesh, ckpt_dir):
    """On a (2, 2) mesh: each ``ROUND_CASES`` case's f32 rounds; an
    Adafactor trainer interrupted after round 0 and resumed from its
    checkpoint, and an uninterrupted one."""
    out = {"rounds": [S.f32_rounds(round_cfg(*case[:2]), case[2], 2, mesh)
                      for case in ROUND_CASES]}
    cfg = resume_cfg()
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
    out["resumed"] = (first, tr2.start_round, tr2.run()) + R._state_np(tr2)
    straight = _trainer(cfg, mesh)
    out["straight"] = (straight.run(),) + R._state_np(straight)
    return out


def shared_grid_rank(mesh):
    """On a (2, 2, 1) mesh in shared mode: each ``SHARED_ROUND_CASES``
    case's f32 rounds."""
    return {"rounds": [S.f32_rounds(round_cfg(name, opt, "shared"), kind, 2,
                                    mesh)
                       for name, opt, kind in SHARED_ROUND_CASES]}
