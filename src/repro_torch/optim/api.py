"""Optimizers on parameter trees (plain PyTorch): SGD + momentum, AdamW with
f32 moments, Adafactor (factored second moments), and the warmup+cosine
schedule.

Unlike the reference's pure functions, the state updates in place: at
full width the K clients' f32 moments are the largest state on the card,
and a copy per step would not fit beside them.  Each optimizer's state is
all zeros at ``init``, as the reference's is.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], tuple[Any, Any]]
    name: str


# --------------------------------------------------------------------------
# Schedules (f32 arithmetic, as the reference computes them)
# --------------------------------------------------------------------------

def warmup_cosine(peak_lr: float, warmup: int = 100, total: int = 10000,
                  floor: float = 0.1):
    f32 = np.float32

    def lr(step) -> float:
        step = f32(step)
        if step < warmup:
            return float(f32(peak_lr) * min(step / f32(max(warmup, 1)), f32(1)))
        frac = np.clip((step - f32(warmup)) / f32(max(total - warmup, 1)),
                       f32(0), f32(1))
        cos = f32(peak_lr) * (f32(floor) + f32((1 - floor) * 0.5)
                              * (f32(1) + np.cos(f32(np.pi) * frac)))
        return float(cos)
    return lr


def constant(lr_val: float):
    return lambda step: float(np.float32(lr_val))


# --------------------------------------------------------------------------
# SGD + momentum
# --------------------------------------------------------------------------

def sgdm(lr=constant(1e-2), momentum: float = 0.9) -> Optimizer:
    """The momentum ``mu`` is kept in each parameter's dtype (bf16 for bf16
    leaves), as the reference keeps it; ``momentum`` is rounded to that
    dtype first, as JAX rounds a Python scalar to the array's dtype."""
    def init(params):
        return {"mu": T.tree_map(torch.zeros_like, params)}

    def update(grads, state, params, step):
        """-> (updates, state); ``state["mu"]`` is updated in place."""
        neg_lr = -lr(step)

        def upd(g, m):
            with torch.no_grad():
                mom = float(torch.tensor(momentum, dtype=m.dtype))
                m.mul_(mom).add_(g.to(m.dtype))
                return m * neg_lr
        return T.tree_map(upd, grads, state["mu"]), state

    return Optimizer(init, update, "sgdm")


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

def adamw(lr=constant(3e-4), b1=0.9, b2=0.95, eps=1e-8, wd=0.01,
          moment_dtype=torch.float32) -> Optimizer:
    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
        return {"m": T.tree_map(z, params), "v": T.tree_map(z, params)}

    def update(grads, state, params, step):
        """-> (updates, state); ``state``'s moments are updated in place."""
        t = np.float32(step) + np.float32(1)
        c1 = float(np.float32(1) - np.float32(b1) ** t)
        c2 = float(np.float32(1) - np.float32(b2) ** t)
        neg_lr = -lr(step)

        def upd(g, m, v, p):
            with torch.no_grad():
                gf = g.float()
                m.mul_(b1).add_(gf, alpha=1 - b1)
                v.mul_(b2).addcmul_(gf, gf, value=1 - b2)
                denom = (v / c2).sqrt_().add_(eps)
                step_v = (m / c1).div_(denom).add_(p.float(), alpha=wd)
                return step_v.mul_(neg_lr).to(p.dtype)

        updates = T.tree_map(upd, grads, state["m"], state["v"], params)
        return updates, state

    return Optimizer(init, update, "adamw")


# --------------------------------------------------------------------------
# Adafactor (factored second moments, no momentum)
# --------------------------------------------------------------------------

def adafactor(lr=constant(1e-3), decay=0.8, eps=1e-30,
              clip_threshold=1.0) -> Optimizer:
    """Factored for >=2-D parameters (state: the f32 means over the last
    and over the second-to-last dim, O(n+m) not O(nm)); a full f32 second
    moment for 1-D ones.  The state tree is ``{"f": {leaf path: {"vr",
    "vc"} or {"v"}}}``, the reference's."""

    def init(params):
        def f(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if p.dim() >= 2:
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return {"f": T.tree_map(f, params)}

    def update(grads, state, params, step):
        """-> (updates, state); the factors are updated in place.  The
        arithmetic keeps the reference's order in f32: ``beta = 1 -
        t**-decay``, ``prec = (vr / mean(vr)) * vc``, and the update's RMS
        clip over the whole leaf."""
        t = np.float32(step) + np.float32(1)
        beta = float(np.float32(1) - t ** np.float32(-decay))
        one_m_beta = float(np.float32(1) - np.float32(beta))
        neg_lr = -lr(step)

        def upd(g, s, p):
            with torch.no_grad():
                gf = g.float()
                g2 = gf.square().add_(eps)
                if p.dim() >= 2:
                    vr, vc = s["vr"], s["vc"]
                    vr.mul_(beta).add_(g2.mean(dim=-1).mul_(one_m_beta))
                    vc.mul_(beta).add_(g2.mean(dim=-2).mul_(one_m_beta))
                    del g2
                    denom = vr.mean(dim=-1, keepdim=True).clamp_min_(eps)
                    prec = (vr / denom)[..., None] * vc[..., None, :]
                    r = prec.clamp_min_(eps).rsqrt_()
                else:
                    s["v"].mul_(beta).add_(g2.mul_(one_m_beta))
                    del g2
                    r = s["v"].clamp_min(eps).rsqrt_()
                u = gf.mul_(r) if gf is not g else gf * r   # g stays whole
                del r
                rms = u.square().mean().add_(1e-12).sqrt_()
                u.div_(torch.clamp_min(rms / clip_threshold, 1.0))
                return u.mul_(neg_lr).to(p.dtype)

        # each grad leaf meets its {"vr", "vc"} or {"v"} node of the state
        return T.tree_map(upd, grads, state["f"], params), state

    return Optimizer(init, update, "adafactor")


# --------------------------------------------------------------------------

def make_optimizer(cfg: ArchConfig, lr: Optional[float] = None,
                   total_steps: int = 10000) -> Optimizer:
    sched = warmup_cosine(lr or 3e-4, warmup=min(100, total_steps // 10 + 1),
                          total=total_steps)
    if cfg.optimizer == "adafactor":
        return adafactor(sched)
    if cfg.optimizer == "sgdm":
        return sgdm(sched)
    return adamw(sched)


def apply_updates(params, updates):
    """``params + updates`` in each parameter's dtype, written in place into
    ``params`` (the client slots of the parameter bank); returns ``params``."""
    def one(p, u):
        with torch.no_grad():
            p.add_(u.to(p.dtype))
        return p
    return T.tree_map(one, params, updates)
