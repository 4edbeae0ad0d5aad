"""Aggregation data plane on one device.

The reference runs aggregation as compiled collectives over a client mesh
axis (one grouped psum per cluster level for ``tree``).  On one GPU the K
clients share the card, so for a ``sum`` strategy (``fedavg``) the
``tree``, ``flat`` and ``rs_ag`` schedules compute the same weighted K-way
mean: ``tree``'s per-level partial sums add up to the flat sum
(``fedavg_tree_ref`` == ``fedavg_ref``).  It is one fedavg kernel launch
per leaf on the (K, N) view of the client-stacked bank, and the mean is
written back into every client slot, as the reference's broadcast does.  ``level_groups``/``head_masks`` matter
again only when clients sit on different GPUs (the multi-GPU slice).

``compressed`` is the reference's int8 form: each client's weighted f32
contribution ``leaf.float() * w[k]`` is quantized per last-dim row with
``dist/compression.quantize_int8``, the (K, ...) int8 stack (on one card
it *is* the payload the reference all-gathers) goes through one qagg
kernel launch with unit weights, and the sum is divided by the weight
total and cast back.  The quantize pass runs over whole rows in chunks of
at most ``CHUNK`` elements per client, so the f32 temporaries of a 545 M
element embed table stay small; quantization is row-local, so chunking
changes no bit.

``stack`` strategies and the ``fedprox`` premap wait for later slices
(see ROADMAP.md).
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch import tree as T
from repro_torch.api.strategies import AggregationStrategy, get_strategy
from repro_torch.core.topology import AggSchedule
from repro_torch.dist.compression import quantize_int8
from repro_torch.kernels.fedavg.ops import fedavg, qagg

CHUNK = 1 << 26       # elements per client in one step of the quantize pass


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
    if schedule.kind not in ("tree", "flat", "rs_ag", "compressed"):
        raise NotImplementedError(
            f"schedule {schedule.kind!r} is not ported yet (see ROADMAP.md)")
    with torch.no_grad():
        for leaf in T.leaves(bank):
            K = leaf.shape[0]
            if schedule.kind == "compressed":
                mean = _compressed_mean(leaf, weights)
            else:
                mean = fedavg(leaf.view(K, -1), weights)
            leaf.copy_(mean.view(1, *leaf.shape[1:]).expand_as(leaf))
    return bank


def _compressed_mean(leaf: torch.Tensor, weights: torch.Tensor):
    """The weighted mean of one client-stacked leaf through int8: quantize
    each client's contribution per last-dim row, qagg the payloads, divide
    by the weight total (summed k = 0..K-1), cast to the leaf's dtype.

    This is the reference's arithmetic as written and as it runs op by op
    (``amax / 127`` divided, products and sums rounded apart), and it
    matches that form bit for bit.  Under ``jax.jit`` XLA rewrites the
    division into a reciprocal multiply and fuses the sum into FMAs; those
    rewrites are XLA's choices, not the algorithm, so the port holds to
    the eager form and agrees with the jitted one to a few ulps of the sum
    (a quantization step for the rare value at a rounding tie)."""
    K = leaf.shape[0]
    G = leaf.shape[-1] if leaf.dim() > 1 else 1
    x = leaf.view(K, -1, G)
    R = x.shape[1]
    q = torch.empty(x.shape, dtype=torch.int8, device=leaf.device)
    s = torch.empty((K, R, 1), dtype=torch.float32, device=leaf.device)
    w = weights.view(K, 1, 1)
    step = max(1, CHUNK // G)
    for r0 in range(0, R, step):
        rows = slice(r0, r0 + step)
        q[:, rows], s[:, rows] = quantize_int8(x[:, rows].float() * w)
    total = weights[0]
    for k in range(1, K):
        total = total + weights[k]
    summed = qagg(q, s, torch.ones_like(weights))
    del q, s
    return summed.div_(total).to(leaf.dtype)
