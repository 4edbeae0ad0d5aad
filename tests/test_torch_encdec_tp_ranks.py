"""Rank-side helpers of tests/test_torch_encdec_tp.py: the module-level
functions ``launch.mesh.spawn`` runs on each rank of a (data, model) or
(pod, data, model) mesh for the encoder-decoder (whisper-small) and the
VLM (internvl2-2b), and the configs and inputs both sides share.  This
module imports torch and the port only (no jax), so a rank starts
quickly; it holds no tests."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core import fl_step
from repro_torch.dist import fsdp
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.models import attention as attn
from repro_torch.models import inputs, model_api
from repro_torch.serve.engine import ServeEngine

import test_torch_serve_tp_ranks as V
import test_torch_shared_ranks as S
import test_torch_tp_ranks as R

ARCHS = {"whisper": "whisper-small", "vlm": "internvl2-2b"}
# whisper's smoke config with 96 frames: above the smoke attention
# threshold of 64, so the encoder and the cross-attention take the flash
# path too, and three whole chunks of 32 (the reference's flash path
# attends its zero padding when unmasked, ROADMAP R5)
FRAMES = 96
GRAD_SEQ = R.GRAD_SEQ        # above the threshold: the decoder's flash path


def config(name: str, mode: str = "replica", frames=None, **kw):
    """The smoke config of case ``name`` (4 q and 2 kv heads: split at
    M = 2, the kv heads whole at M = 4) in ``mode``; ``frames``: whisper's
    frame count."""
    cfg = smoke_config(get_arch(ARCHS[name]))
    if frames is not None:
        kw["frontend"] = dataclasses.replace(cfg.frontend, n_tokens=frames)
    return cfg.replace(fl=cfg.fl.__class__(mode=mode), **kw)


def frontend_name(cfg) -> str:
    return "frames" if cfg.family == "encdec" else "patches"


def as_batch(batch_np) -> dict:
    """numpy batch -> CPU tensors, the frontend's embeddings in bf16."""
    return {k: torch.from_numpy(v).to(torch.bfloat16 if v.dtype
                                      == np.float32 else None)
            for k, v in batch_np.items()}


# ---------------------------------------------------------------------------
# (b), (c) one client's loss and gradients
# ---------------------------------------------------------------------------

# mesh -> the client cases spawned on it: (name, mode, remat)
CLIENT_CASES = {(1, 2): [("whisper", "replica", False),
                         ("vlm", "replica", False)],
                (1, 4): [("whisper", "replica", True),
                         ("vlm", "replica", True)],
                (1, 2, 2): [("whisper", "shared", False),
                            ("vlm", "shared", False)]}


def client_cfg(name, mode="replica", remat=False):
    return config(name, mode, FRAMES if name == "whisper" else None,
                  remat=remat)


def client_loss(cfg, mesh, params_np, batch_np):
    """This rank's loss and the gradient of its block of every leaf at
    f32, and the q and kv heads of every flash call."""
    tp = tpar.axis_for(cfg, mesh)
    dp = fl_step.data_axis_for(cfg, mesh)
    specs = fl_step.param_specs(cfg, mesh)
    live = T.tree_map(lambda t: t.clone().requires_grad_(),
                      R.blocks_of(S.whole(params_np), specs, mesh))
    batch = as_batch(batch_np)
    if dp is not None:
        batch, split = inputs.rank_rows(batch, dp.size, dp.rank)
        dp = dp.with_split(split)
    calls, real = [], attn.flash_fwd

    def spy(q, k, v, *a, **kw):
        calls.append((q.shape[2], k.shape[2]))
        return real(q, k, v, *a, **kw)
    attn.flash_fwd = spy
    try:
        loss, _ = model_api.loss_fn(cfg, live, batch, tp, dp)
    finally:
        attn.flash_fwd = real
    grads = list(torch.autograd.grad(loss, T.leaves(live)))
    if dp is not None:
        grads = fsdp.reduce_replicated(
            grads, fl_step.leaf_path_names(live), dp)
    return {"loss": loss.item(), "flash": calls,
            "grads": T.unflatten_like(live, [g.numpy() for g in grads])}


def client_rank(mesh, cases):
    """Each (name, mode, remat, f32 parameters, batch) case's loss and
    gradients on this rank."""
    return {name: client_loss(client_cfg(name, mode, remat), mesh, params,
                              batch)
            for name, mode, remat, params, batch in cases}


# ---------------------------------------------------------------------------
# (d) rounds
# ---------------------------------------------------------------------------

# (name, optimizer, schedule) on a (2, 2) mesh in replica mode, K = 2
# clients of 2 model ranks, and on a (2, 2, 1) mesh in shared mode, K = 2
# pods of 2 data ranks (batch 2 split)
ROUND_CASES = [("whisper", "adamw", "tree"), ("whisper", "adamw", "compressed"),
               ("vlm", "adamw", "flat")]
SHARED_ROUND_CASES = [("whisper", "adamw", "tree"), ("vlm", "adamw", "tree")]


def round_cfg(name: str, opt: str, mode: str = "replica"):
    return config(name, mode, optimizer=opt)


def round_batches(cfg, K: int):
    """``S.batches``' tokens of each round with the frontend's embeddings
    from a numpy seed, (K, BPC, n, feat_dim) in bf16."""
    fe, rng = cfg.frontend, np.random.default_rng(11)
    out = []
    for b in S.batches(K, cfg.vocab):
        x = rng.standard_normal((K, S.BPC, fe.n_tokens, fe.feat_dim))
        out.append({**b, frontend_name(cfg): torch.from_numpy(
            x.astype(np.float32)).to(torch.bfloat16)})
    return out


def frontend_rounds(cfg, kind, K, mesh=None, blocks=None):
    """``S.f32_rounds`` with the frontend's inputs in every batch."""
    return S.f32_rounds(cfg, kind, K, mesh, blocks,
                        lambda K_, vocab: round_batches(cfg, K_))


def grid_rank(mesh, cases, mode):
    return {"rounds": [frontend_rounds(round_cfg(name, opt, mode), kind, 2,
                                       mesh) for name, opt, kind in cases]}


# ---------------------------------------------------------------------------
# (e) serving
# ---------------------------------------------------------------------------

# mesh -> (name, prompt lengths, whisper's frames, the self cache's layout,
# the cross cache's).  A self cache has S + MAX_NEW + 1 slots; the cross
# cache the frames, split on their sequence where they divide M, else on
# the kv heads where 2 divides M, else whole
SERVE_CASES = {
    (1, 2): [("whisper", (28, 9, 28, 28), 8, "seq", "seq"),
             ("whisper", (29, 29, 3, 29), 5, "heads", "heads"),
             ("vlm", (28, 20, 28, 5), None, "seq", None)],
    (2, 2): [("whisper", (29, 29, 12, 29), 8, "heads", "seq"),
             ("vlm", (29, 29, 29, 14), None, "heads", None)],
    (1, 4): [("whisper", (28, 28, 28, 11), 6, "seq", "whole")],
}


def serve_inputs(cfg, B: int, seed: int):
    """The frontend's embeddings of a served batch of B rows, f32 numpy
    exact in bf16."""
    fe = cfg.frontend
    x = np.random.default_rng(seed).standard_normal(
        (B, fe.n_tokens, fe.feat_dim)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


class FrontendEngine(ServeEngine):
    """``ServeEngine`` with the frames or patches ``x`` (the whole batch's,
    numpy) in place of its zero stub inputs, the rank taking its rows."""

    def __init__(self, *args, frontend=None, **kw):
        super().__init__(*args, **kw)
        self.x = frontend

    def _extra_inputs(self, B, S):
        n = self.cfg.frontend.n_tokens if self.cfg.family == "encdec" \
            else min(self.cfg.frontend.n_tokens, S)
        x = torch.from_numpy(self.x[self.rows(len(self.x)), :n])
        assert x.shape[0] == B
        return {frontend_name(self.cfg): x.to(torch.bfloat16)}


def serve(cfg, params, lens, seed, mesh=None):
    """``V.serve`` with the case's frames or patches from the seed."""
    return V.serve(cfg, params, lens, seed, mesh, functools.partial(
        FrontendEngine, frontend=serve_inputs(cfg, len(lens), seed)))


def serve_rank(mesh, params_np):
    """Every ``SERVE_CASES`` case of this mesh on this rank (``params_np``:
    name -> the whole f32 parameters, which do not depend on whisper's
    frame count), with the specs of each case's cache."""
    from repro_torch.models import kvcache as kvc
    shape = (mesh.shape["data"], mesh.shape["model"])
    out = []
    for i, (name, lens, frames, _, _) in enumerate(SERVE_CASES[shape]):
        cfg = config(name, frames=frames)
        res = serve(cfg, S.whole(params_np[name]), lens, i, mesh)
        decls = model_api.get_model(cfg).cache_decl(
            cfg, len(lens), kvc.serve_cache_len(cfg, max(lens), V.MAX_NEW,
                                                256))
        res["specs"] = kvc.cache_specs(cfg, decls, mesh)
        res["decl_shapes"] = T.tree_map(lambda d: d.shape, decls)
        out.append(res)
    return out


def grid_and_serve_rank(mesh, cases, mode, params_np):
    """On a (2, 2) mesh: the rounds, then the serving cases."""
    out = grid_rank(mesh, cases, mode)
    out["serve"] = serve_rank(mesh, params_np)
    return out


def client_and_serve_rank(mesh, cases, params_np):
    """The client cases, then (on a mesh with serving cases) those."""
    out = client_rank(mesh, cases)
    if len(mesh.shape) == 2 and (mesh.shape["data"], mesh.shape["model"]) \
            in SERVE_CASES:
        out["serve"] = serve_rank(mesh, params_np)
    return out


def world1_rank(mesh, names):
    """``V.world1_rank`` for whisper and the VLM, with ``serve``'s frames
    and patches."""
    return V.world1_rank(mesh, names, config, serve)
