"""Plain optimizers and the learning-rate schedule, in float32.

AdamW (decoupled weight decay on every leaf) and Adafactor (factored
second moments over the last two dims of a leaf of two or more dims, no
momentum, the update clipped to RMS 1), as the federated trainer states
them, with its linear-warmup cosine schedule.  Each optimizer keeps one
client's state and updates the parameters in place.
"""
from __future__ import annotations

import math

import torch

PEAK_LR = 3e-4


def lr_at(step: int, total: int, peak: float = PEAK_LR,
          floor: float = 0.1) -> float:
    warmup = min(100, total // 10 + 1)
    if step < warmup:
        return peak * min(step / max(warmup, 1), 1.0)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac)))


class AdamW:
    name = "adamw"

    def __init__(self, params: dict, b1=0.9, b2=0.95, eps=1e-8, wd=0.01):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, wd
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    def step(self, params: dict, grads: dict, step: int, lr: float):
        t = step + 1
        c1, c2 = 1 - self.b1 ** t, 1 - self.b2 ** t
        for n, p in params.items():
            g, m, v = grads[n], self.m[n], self.v[n]
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (m / c1).div_((v / c2).sqrt_().add_(self.eps))
            p.add_(upd.add_(p, alpha=self.wd), alpha=-lr)
            del upd


class Adafactor:
    name = "adafactor"

    def __init__(self, params: dict, decay=0.8, eps=1e-30, clip=1.0):
        self.decay, self.eps, self.clip = decay, eps, clip
        self.f = {}
        for n, p in params.items():
            if p.dim() >= 2:
                self.f[n] = {"vr": torch.zeros(p.shape[:-1], device=p.device),
                             "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                               device=p.device)}
            else:
                self.f[n] = {"v": torch.zeros_like(p)}

    def step(self, params: dict, grads: dict, step: int, lr: float):
        beta = 1 - (step + 1) ** (-self.decay)
        for n, p in params.items():
            g, s = grads[n], self.f[n]
            g2 = g.square().add_(self.eps)
            if p.dim() >= 2:
                s["vr"].mul_(beta).add_(g2.mean(-1), alpha=1 - beta)
                s["vc"].mul_(beta).add_(g2.mean(-2), alpha=1 - beta)
                del g2
                denom = s["vr"].mean(-1, keepdim=True).clamp_min(self.eps)
                u = (s["vr"] / denom)[..., None] * s["vc"][..., None, :]
            else:
                s["v"].mul_(beta).add_(g2, alpha=1 - beta)
                del g2
                u = s["v"].clone()
            u = u.clamp_min_(self.eps).rsqrt_().mul_(g)      # g / sqrt(v)
            rms = (u.square().mean() + 1e-12).sqrt()
            p.add_(u.div_(torch.clamp_min(rms / self.clip, 1.0)), alpha=-lr)
            del u


def make(name: str, params: dict):
    return {"adamw": AdamW, "adafactor": Adafactor}[name](params)
