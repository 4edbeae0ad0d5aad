"""FedAvg: the next global model is the mean of the clients' models,
weighted by their sample counts, in float32.

Under the ``compressed`` schedule each client's weighted model goes to
the sum through int8, per last-dim row, with the scale absmax / 127.
Under ``tree``, ``flat`` and ``rs_ag`` it goes as it is: on one card
these schedules compute the same mean.  Any other schedule raises.

A strategy module of the reference gives ``Combine(schedule, weights)``,
with ``add(k, params)`` for each client in turn and ``result()`` for the
next global model.  It may also give ``penalty(params, start)``, a term
added to each local step's loss, where ``start`` is the round's starting
model; FedAvg has none.
"""
from __future__ import annotations

import torch

SCHEDULES = ("tree", "flat", "rs_ag", "compressed")


def quantize_rows(x: torch.Tensor) -> torch.Tensor:
    """x through int8 per last-dim row (scale absmax / 127) and back."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    amax = torch.where(amax > 0, amax, torch.ones_like(amax))
    scale = amax / torch.full_like(amax, 127.0)
    return torch.round(x / scale).clamp(-127, 127) * scale


class Combine:
    def __init__(self, schedule: str, weights: torch.Tensor):
        if schedule not in SCHEDULES:
            raise ValueError(f"the reference's fedavg has no schedule "
                             f"{schedule!r}; it models {SCHEDULES}")
        self.codec = schedule == "compressed"
        self.w = weights
        self.acc: dict = {}

    def add(self, k: int, params: dict):
        for n, p in params.items():
            c = p * self.w[k]
            if self.codec:
                c = quantize_rows(c)
            if n in self.acc:
                self.acc[n].add_(c)
            else:
                self.acc[n] = c

    def result(self) -> dict:
        total = self.w.sum()
        out = {n: a.div_(total) for n, a in self.acc.items()}
        self.acc = {}
        return out
