"""Aggregation data plane on one device.

The reference runs aggregation as compiled collectives over a client mesh
axis (one grouped psum per cluster level for ``tree``).  On one GPU the K
clients share the card, so for a ``sum`` strategy (``fedavg``) every
schedule computes the same weighted K-way mean: ``tree``'s per-level
partial sums add up to the flat sum (``fedavg_tree_ref`` == ``fedavg_ref``).
It is one fedavg kernel launch per leaf on the (K, N) view of the
client-stacked bank, and the mean is written back into every client slot,
as the reference's broadcast does.  ``level_groups``/``head_masks`` matter
again only when clients sit on different GPUs (the multi-GPU slice).

``stack`` strategies, the ``fedprox`` premap, and the ``rs_ag`` /
``compressed`` forms wait for later slices (see ROADMAP.md).
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch import tree as T
from repro_torch.api.strategies import AggregationStrategy, get_strategy
from repro_torch.core.topology import AggSchedule
from repro_torch.kernels.fedavg.ops import fedavg


def check_strategy(strategy: Union[str, AggregationStrategy]):
    """The strategy, if its aggregation is ported; raises otherwise."""
    strat = get_strategy(strategy)
    if not strat.compiled:
        raise ValueError(
            f"strategy {strat.name!r} has no compiled collective form "
            "(host path / Federation facade only)")
    if (strat.reduction != "sum" or strat.needs_ref
            or type(strat).premap is not AggregationStrategy.premap):
        raise NotImplementedError(
            f"strategy {strat.name!r} is not ported yet: only plain weighted "
            "sums (fedavg) are; see ROADMAP.md")
    return strat


def aggregate_params(bank, weights: torch.Tensor, schedule: AggSchedule,
                     strategy: Union[str, AggregationStrategy] = "fedavg"):
    """bank: client-stacked tree (leading dim = n_clients); weights:
    (n_clients,) f32 on the bank's device.  Every client slot is
    overwritten in place with the weighted mean; returns ``bank``."""
    check_strategy(strategy)
    if schedule.kind not in ("tree", "flat", "rs_ag"):
        raise NotImplementedError(
            f"schedule {schedule.kind!r} is not ported yet (see ROADMAP.md)")
    with torch.no_grad():
        for leaf in T.leaves(bank):
            K = leaf.shape[0]
            mean = fedavg(leaf.view(K, -1), weights)
            leaf.copy_(mean.view(1, *leaf.shape[1:]).expand_as(leaf))
    return bank
