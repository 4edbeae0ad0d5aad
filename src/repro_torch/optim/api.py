"""Optimizers on parameter trees (plain PyTorch): AdamW with f32 moments and
the warmup+cosine schedule.  ``sgdm`` and ``adafactor`` wait for a later
slice.

Unlike the reference's pure functions, the moments update in place: at
full width the K clients' f32 moments are the largest state on the card,
and a copy per step would not fit beside them.
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

def make_optimizer(cfg: ArchConfig, lr: Optional[float] = None,
                   total_steps: int = 10000) -> Optimizer:
    sched = warmup_cosine(lr or 3e-4, warmup=min(100, total_steps // 10 + 1),
                          total=total_steps)
    if cfg.optimizer != "adamw":
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported yet (see ROADMAP.md)")
    return adamw(sched)


def apply_updates(params, updates):
    """``params + updates`` in each parameter's dtype, written in place into
    ``params`` (the client slots of the parameter bank); returns ``params``."""
    def one(p, u):
        with torch.no_grad():
            p.add_(u.to(p.dtype))
        return p
    return T.tree_map(one, params, updates)
