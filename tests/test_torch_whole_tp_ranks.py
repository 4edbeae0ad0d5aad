"""Rank-side helpers of tests/test_torch_whole_tp.py: the configs both
sides share and the module-level functions ``launch.mesh.spawn`` runs on
each rank, for the model axis where the reference's resolver leaves a dim
whole (the padded vocab, an MLP width, the experts) or where a rank's q
heads straddle kv groups.  This module imports torch and the port only (no
jax), so a rank starts quickly; it holds no tests."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree as T
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core import fl_step
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.launch.train import SDFLMQTrainer
from repro_torch.models import attention as attn
from repro_torch.models import model_api

import test_torch_encdec_tp_ranks as E
import test_torch_serve_tp_ranks as V
import test_torch_shared_ranks as S
import test_torch_tp_ranks as R

# case -> (arch, overrides of its smoke config).  At M = 3 the smoke
# configs' vocab (256), d_ff (128), 4 heads, 4 experts of 32 and feat_dim
# (64) all stay whole; the overrides give the split dims beside them:
#   dense6    6 q and 3 kv heads: both split at 3, vocab and MLP whole
#   straddle  12 q and 3 kv heads: at M = 2, 6 q heads a rank against
#             groups of 4 (kv whole), vocab and MLP split
#   mixtral   experts, their width, heads and vocab whole at 3
#   kimi      its dense layer (64), shared expert (32) and experts whole
#   rwkv      rwkv6's heads, d_ff, cm.wr's d_model and vocab whole at 3
#   hymba     Hymba's heads, MLP and vocab whole at 3
#   whisper6  6 heads (split at 3) and d_ff 96 (split), vocab whole:
#             whisper-small's own layout at M = 3; 96 frames (flash path)
#   vlm6      6 q and 2 kv heads: at M = 3 the q heads split and straddle
#             groups of 3; MLP, feat_dim and vocab whole
#   mlp_odd   d_ff 129: the MLP whole at M = 2 beside split heads and
#             vocab
CASES = {
    "dense6": ("qwen2-7b", {"n_heads": 6, "n_kv_heads": 3}),
    "straddle": ("qwen2-7b", {"n_heads": 12, "n_kv_heads": 3}),
    "mixtral": ("mixtral-8x22b", {}),
    "kimi": ("kimi-k2-1t-a32b", {}),
    "rwkv": ("rwkv6-7b", {}),
    "hymba": ("hymba-1.5b", {}),
    "whisper6": ("whisper-small", {"n_heads": 6, "n_kv_heads": 6,
                                   "d_ff": 96}),
    "vlm6": ("internvl2-2b", {"n_heads": 6, "n_kv_heads": 2}),
    "mlp_odd": ("qwen2-7b", {"d_ff": 129}),
}


def config(name: str, mode: str = "replica", **kw):
    """The smoke config of case ``name`` (``CASES``) in ``mode``."""
    arch, over = CASES[name]
    cfg = smoke_config(get_arch(arch)).replace(**over)
    if cfg.family == "encdec":
        kw["frontend"] = dataclasses.replace(cfg.frontend,
                                             n_tokens=E.FRAMES)
    return cfg.replace(fl=cfg.fl.__class__(mode=mode), **kw)


# ---------------------------------------------------------------------------
# (b) one client's loss and gradients
# ---------------------------------------------------------------------------

# mesh -> the client cases spawned on it
CLIENT_CASES = {(1, 3): ["dense6", "mixtral", "kimi", "rwkv", "hymba",
                         "whisper6", "vlm6"],
                (1, 2): ["straddle"]}


def client_loss(cfg, mesh, params_np, batch_np):
    """This rank's loss, the gradient of its block of every leaf at f32,
    its ``split_blocks`` decisions, and the q and kv heads of every flash
    call."""
    tp = tpar.axis_for(cfg, mesh)
    specs = fl_step.param_specs(cfg, mesh)
    live = T.tree_map(lambda t: t.clone().requires_grad_(),
                      R.blocks_of(S.whole(params_np), specs, mesh))
    calls, real = [], attn.flash_fwd

    def spy(q, k, v, *a, **kw):
        calls.append((q.shape[2], k.shape[2]))
        return real(q, k, v, *a, **kw)
    attn.flash_fwd = spy
    try:
        loss, _ = model_api.loss_fn(cfg, live, E.as_batch(batch_np), tp)
    finally:
        attn.flash_fwd = real
    grads = torch.autograd.grad(loss, T.leaves(live))
    return {"loss": loss.item(), "flash": calls, "blocks": tp.blocks,
            "straddle": tp.straddle,
            "grads": T.unflatten_like(live, [g.numpy() for g in grads])}


def client_rank(mesh, cases, serve_cases=(), serve_params=None):
    """Each (name, f32 parameters, batch) case's loss and gradients on
    this rank; then each ``serve_cases`` case served (``serve``)."""
    out = {name: client_loss(config(name), mesh, params, batch)
           for name, params, batch in cases}
    out["serve"] = [serve_case(mesh, case, serve_params[case[0]], i)
                    for i, case in enumerate(serve_cases)]
    return out


# ---------------------------------------------------------------------------
# serving: prefill and teacher-forced decode
# ---------------------------------------------------------------------------

# mesh -> (case, prompt lengths, the cache layout a rank holds).  A
# full-attention cache has S + V.MAX_NEW + 1 slots: it splits on its
# sequence where that divides M, else on the kv heads where they divide
# M, else stays whole
SERVE_CASES = {(1, 2): [("straddle", (28, 20, 28, 9), "seq"),
                        ("straddle", (29, 7, 29, 29), "whole")],
               (1, 3): [("dense6", (29, 29, 9, 29), "seq"),
                        ("dense6", (28, 11, 28, 28), "heads"),
                        ("vlm6", (28, 28, 28, 5), "whole")]}


def serve(cfg, params, lens, seed, mesh=None):
    """``V.serve``, or for the VLM ``E.serve`` (its patches from the
    seed)."""
    fn = E.serve if cfg.frontend is not None else V.serve
    return fn(cfg, params, lens, seed, mesh)


def serve_case(mesh, case, params_np, seed):
    """One serving case on this rank: its rows' logits (prefill and each
    teacher-forced step), its cache layout and its greedy tokens."""
    name, lens, _ = case
    return serve(config(name), S.whole(params_np), lens, seed, mesh)


# ---------------------------------------------------------------------------
# (b) rounds and resume
# ---------------------------------------------------------------------------

# (case, optimizer, schedule): f32 rounds, K = 2, on a (2, 2) mesh in
# replica mode and a (2, 1, 2) one in shared mode (one client a pod)
GRID_CASES = [("mlp_odd", "adamw", "compressed"),
              ("mlp_odd", "adafactor", "tree")]
SHARED_CASES = [("mlp_odd", "adamw", "flat")]


def round_cfg(name: str, opt: str, mode: str = "replica"):
    return config(name, mode, optimizer=opt)


def _trainer(cfg, mesh, ckpt_dir=None):
    return SDFLMQTrainer(cfg, 2, S.ROUNDS, R.BPC, R.SEQ, seed=0,
                         device="cpu", mesh=mesh, ckpt_dir=ckpt_dir)


def resume_cfg():
    """The resume case: d_ff 129 (the MLP whole on (2, 2)) under
    Adafactor."""
    return round_cfg("mlp_odd", "adafactor")


def grid_rank(mesh, ckpt_dir):
    """On a (2, 2) mesh: each ``GRID_CASES`` case's f32 rounds; an
    Adafactor trainer interrupted after round 0 and resumed from its block
    checkpoint, and an uninterrupted one."""
    out = {"rounds": [S.f32_rounds(round_cfg(*c[:2]), c[2], 2, mesh)
                      for c in GRID_CASES]}
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


def shared_rank(mesh):
    """On a (2, 1, 2) mesh in shared mode: each ``SHARED_CASES`` case's
    f32 rounds."""
    return {"rounds": [S.f32_rounds(round_cfg(name, opt, "shared"), kind, 2,
                                    mesh)
                       for name, opt, kind in SHARED_CASES]}
