"""Aggregation data plane on one device.

The reference runs aggregation as compiled collectives over a client mesh
axis (one grouped psum per cluster level for ``tree``).  On one GPU the K
clients share the card, so for a ``sum`` strategy the ``tree``, ``flat``
and ``rs_ag`` schedules compute the same weighted K-way mean: ``tree``'s
per-level partial sums add up to the flat sum (``fedavg_tree_ref`` ==
``fedavg_ref``).  The mean is written back into every client slot, as the
reference's broadcast does.  ``level_groups``/``head_masks`` matter again
only when clients sit on different GPUs (the multi-GPU slice).

``sum`` strategies:

* without a premap (fedavg, fedavg_poly), or with no ``ref`` given: one
  fedavg kernel launch per leaf on the (K, N) view of the client-stacked
  bank;
* with a premap and the pre-round parameters ``ref`` (fedprox,
  fedprox_poly, norm_clip): per leaf and per chunk of at most ``CHUNK``
  elements per client, each client's f32 premapped contribution, then one
  launch of the fedavg kernel's f32 entry over the (K, chunk) block, cast
  to the leaf's dtype.  fedprox's premap is the copied ``FedProx.premap``
  run on ``core/xp_torch.py`` chunk by chunk: ``(1-mu)*p + mu*g`` as two
  rounded products and an add, the reference's arithmetic as it runs op by
  op (under ``jax.jit`` XLA may fuse it into a multiply-add).  norm_clip
  needs each client's L2 norm of its update over *all* leaves, so it takes
  two passes: per-client sums of squares, then the contributions.

``compressed`` is the reference's int8 form: each client's weighted f32
contribution (premapped, where the strategy has a premap and ``ref`` is
given) is quantized per last-dim row with ``dist/compression.quantize_int8``,
the (K, ...) int8 stack (on one card it *is* the payload the reference
all-gathers) goes through one qagg kernel launch with unit weights, and the
sum is divided by the weight total and cast back.  Quantization is
row-local, so the pass runs over whole rows in chunks of at most ``CHUNK``
elements per client and chunking changes no bit.

``stack`` strategies (trimmed_mean, coordinate_median,
weighted_trimmed_mean, weighted_median, krum, multi_krum,
clipped_weighted_trimmed_mean) follow the reference's compiled branch: its
churn-aware ``combine_masked``, where rows of weight <= 0 are dead.  On one
card the K-stacked bank *is* the all-gathered stack.  The per-coordinate
combines run the copied hooks unchanged on the torch namespace
``core/xp_torch.py``, one chunk of columns at a time, which changes no bit.
krum and multi_krum select rows by distances over all leaves: their squared
norms and K x K Gram accumulate chunk by chunk in full f32, the selection
runs once, then the selected rows are averaged chunk by chunk.  These
combines are plain PyTorch: the reference computes them outside any Pallas
kernel.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Union

import torch

from repro_torch import tree as T
from repro_torch.api.strategies import (AggregationStrategy,
                                        CoordinateMedian, FedProx, MultiKrum,
                                        TrimmedMean, WeightedMedian,
                                        WeightedTrimmedMean, _live_mask,
                                        _NormClip, get_strategy)
from repro_torch.core.topology import AggSchedule
from repro_torch.core.xp_torch import TorchXP
from repro_torch.dist.compression import quantize_int8
from repro_torch.kernels.fedavg.ops import fedavg, qagg

CHUNK = 1 << 26       # elements per client in one step of a chunked pass

# the premaps and masked combines whose torch form is known here
_PREMAPS = (AggregationStrategy.premap, FedProx.premap, _NormClip.premap)
_COMBINES = (TrimmedMean.combine_masked, CoordinateMedian.combine_masked,
             WeightedTrimmedMean.combine_masked,
             WeightedMedian.combine_masked, MultiKrum.combine_masked)


def check_strategy(strategy: Union[str, AggregationStrategy]):
    """The strategy, if it has a compiled form; raises otherwise."""
    strat = get_strategy(strategy)
    if not strat.compiled:
        raise ValueError(
            f"strategy {strat.name!r} has no compiled collective form "
            "(host path / Federation facade only)")
    cls = type(strat)
    if (strat.reduction not in ("sum", "stack")
            or cls.premap not in _PREMAPS
            or (strat.reduction == "stack"
                and cls.combine_masked not in _COMBINES)):
        raise NotImplementedError(
            f"strategy {strat.name!r} has a premap or combine that the port "
            "has no torch form for")
    return strat


def aggregate_params(bank, weights: torch.Tensor, schedule: AggSchedule,
                     strategy: Union[str, AggregationStrategy] = "fedavg",
                     ref=None):
    """bank: client-stacked tree (leading dim = n_clients); weights:
    (n_clients,) f32 on the bank's device.  Every client slot is
    overwritten in place with the strategy's aggregate; returns ``bank``.

    ``ref`` (same structure as ``bank``) is the pre-round model, read by
    strategies with ``needs_ref``: each leaf's leading dim is n_clients
    (client k premaps against its own slot) or 1 (one model for all).  It
    may live on another device (a pinned host copy); chunks are brought to
    the bank's device as they are needed."""
    strat = check_strategy(strategy)
    if schedule.kind not in ("tree", "flat", "rs_ag", "compressed"):
        raise NotImplementedError(
            f"schedule {schedule.kind!r} is not ported yet (see ROADMAP.md)")
    leaves = T.leaves(bank)
    refs = T.leaves(ref) if strat.needs_ref and ref is not None else None
    with torch.no_grad():
        values = _premap(strat, leaves, refs) if refs is not None else None
        if strat.reduction == "stack":
            if isinstance(strat, MultiKrum):
                _krum(strat, leaves, weights, values)
            else:
                _stack(strat, leaves, weights, values)
        elif schedule.kind == "compressed":
            for i, leaf in enumerate(leaves):
                cols = (lambda c0, c1, i=i: values(i, c0, c1)) \
                    if values else None
                _write(leaf, _compressed_mean(leaf, weights, cols))
        elif values is not None:
            for i, leaf in enumerate(leaves):
                flat = _flat(leaf)
                for c0, c1 in _chunks(flat.shape[1]):
                    flat[:, c0:c1].copy_(
                        fedavg(values(i, c0, c1), weights).to(leaf.dtype))
        else:
            for leaf in leaves:
                _write(leaf, fedavg(_flat(leaf), weights))
    return bank


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.view(t.shape[0], -1)


def _chunks(n: int, step: int = 0):
    step = step or CHUNK
    return [(c0, min(c0 + step, n)) for c0 in range(0, n, step)]


def _write(leaf: torch.Tensor, mean: torch.Tensor):
    """Every client slot of ``leaf`` <- ``mean`` (cast to the leaf's dtype)."""
    leaf.copy_(mean.to(leaf.dtype).view(1, *leaf.shape[1:]).expand_as(leaf))


def _cols(ref: torch.Tensor, c0: int, c1: int, dev) -> torch.Tensor:
    """Columns [c0, c1) of a (R, n) ref on ``dev``, one contiguous row at a
    time when it lives elsewhere (a pinned host copy streams in)."""
    part = ref[:, c0:c1]
    if part.device == dev:
        return part
    out = torch.empty(part.shape, dtype=part.dtype, device=dev)
    for r in range(part.shape[0]):
        out[r].copy_(part[r], non_blocking=True)
    return out


def _premap(strat, leaves, refs):
    """-> values(i, c0, c1): the f32 (K, c1 - c0) premapped contributions
    of leaf i's columns [c0, c1), every client against its ref."""
    dev = leaves[0].device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    flats = [_flat(leaf) for leaf in leaves]
    rflats = [r.reshape(r.shape[0], -1) for r in refs]
    if isinstance(strat, _NormClip):
        # _NormClip.premap, whose norm runs over all leaves: pass 1 sums
        # each client's squared update, leaf by leaf and chunk by chunk
        sq = torch.zeros((leaves[0].shape[0],), dtype=torch.float32,
                         device=dev)
        for x, g in zip(flats, rflats):
            for c0, c1 in _chunks(x.shape[1]):
                d = x[:, c0:c1].float() - _cols(g, c0, c1, dev).float()
                sq += (d * d).sum(dim=1)
        nrm = torch.sqrt(sq)
        scale = torch.minimum(f32(1.0), f32(strat.clip)
                              / torch.maximum(nrm, f32(1e-12)))[:, None]

        def values(i, c0, c1):
            g = _cols(rflats[i], c0, c1, dev).float()
            return g + (flats[i][:, c0:c1].float() - g) * scale
        return values
    xp = TorchXP(dev)

    def values(i, c0, c1):       # FedProx.premap is elementwise: per chunk
        out = strat.premap({"x": flats[i][:, c0:c1]},
                           {"x": _cols(rflats[i], c0, c1, dev)}, xp)["x"]
        return out.as_subclass(torch.Tensor)
    return values


def _stack(strat, leaves, weights, values):
    """The per-coordinate masked combine, chunk by chunk."""
    xp = TorchXP(leaves[0].device)
    w = xp.asarray(weights)
    for i, leaf in enumerate(leaves):
        flat = _flat(leaf)
        for c0, c1 in _chunks(flat.shape[1]):
            s = values(i, c0, c1) if values else flat[:, c0:c1]
            out = strat.combine_masked({"x": xp.asarray(s)}, w, xp)["x"]
            flat[:, c0:c1].copy_(out.to(leaf.dtype))


@contextmanager
def _full_f32_matmul():
    """f32 products in full f32 (no TF32), whatever the caller set."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def _krum(strat: MultiKrum, leaves, weights, values):
    """krum / multi_krum: ``MultiKrum.combine_masked`` with its flat rows'
    squared norms and Gram accumulated leaf by leaf and chunk by chunk
    (concatenating the rows would copy the whole bank in f32)."""
    dev = leaves[0].device
    xp = TorchXP(dev)
    n = leaves[0].shape[0]
    rows = lambda i, c0, c1: (values(i, c0, c1) if values
                              else _flat(leaves[i])[:, c0:c1].float())
    sq = torch.zeros((n,), dtype=torch.float32, device=dev)
    gram = torch.zeros((n, n), dtype=torch.float32, device=dev)
    with _full_f32_matmul():
        for i, leaf in enumerate(leaves):
            for c0, c1 in _chunks(leaf[0].numel()):
                X = rows(i, c0, c1)
                sq += (X * X).sum(dim=1)
                gram += X @ X.T
    # the selection, as MultiKrum.combine_masked writes it
    alive, m_live = _live_mask(xp.asarray(weights), xp)
    d2 = xp.asarray(sq[:, None] + sq[None, :] - 2.0 * gram)
    BIG = xp.float32(1e30)
    dead = ~alive
    d2 = xp.where(dead[:, None] | dead[None, :], BIG, d2)
    d2 = d2 + BIG * xp.eye(n, dtype=xp.float32)      # exclude self
    dsort = xp.sort(d2, axis=1)
    kc = xp.clip(m_live - strat.f - 2, 1, max(n - 1, 1))
    idx = xp.arange(n)[None, :]
    scores = xp.sum(xp.where(idx < kc, dsort, xp.float32(0.0)), axis=1)
    scores = xp.where(dead, xp.float32(xp.inf), scores)
    ranks = xp.argsort(xp.argsort(scores))     # rank of each row
    q = xp.clip(xp.minimum(m_live, strat.m_sel), 1, n)
    sel = (ranks < q)[:, None]                 # exactly q best rows
    qf = xp.maximum(xp.sum(sel.astype(xp.float32)), xp.float32(1.0))
    for i, leaf in enumerate(leaves):
        flat = _flat(leaf)
        for c0, c1 in _chunks(flat.shape[1]):
            s = xp.asarray(rows(i, c0, c1))
            out = xp.sum(xp.where(sel, s, xp.float32(0.0)), axis=0) / qf
            out = xp.where(m_live > 0, out, xp.zeros_like(out))
            flat[:, c0:c1].copy_(out.to(leaf.dtype))


def _compressed_mean(leaf: torch.Tensor, weights: torch.Tensor, values=None):
    """The f32 weighted mean of one client-stacked leaf through int8:
    quantize each client's contribution per last-dim row, qagg the
    payloads, divide by the weight total (summed k = 0..K-1).
    ``values(c0, c1)``, when given, yields the premapped f32 columns.

    This is the reference's arithmetic as written and as it runs op by op
    (``amax / 127`` divided, products and sums rounded apart), and it
    matches that form bit for bit.  Under ``jax.jit`` XLA rewrites the
    division into a reciprocal multiply and fuses the sum into FMAs; those
    rewrites are XLA's choices, not the algorithm, so the port holds to
    the eager form and agrees with the jitted one to a few ulps of the sum
    (a quantization step for the rare value at a rounding tie)."""
    K = leaf.shape[0]
    G = leaf.shape[-1] if leaf.dim() > 1 else 1
    flat = _flat(leaf)
    R = flat.shape[1] // G
    q = torch.empty((K, R, G), dtype=torch.int8, device=leaf.device)
    s = torch.empty((K, R, 1), dtype=torch.float32, device=leaf.device)
    w = weights.view(K, 1, 1)
    for c0, c1 in _chunks(R * G, max(1, CHUNK // G) * G):
        v = values(c0, c1) if values else flat[:, c0:c1].float()
        rows = slice(c0 // G, c1 // G)
        q[:, rows], s[:, rows] = quantize_int8(v.view(K, -1, G) * w)
    total = weights[0]
    for k in range(1, K):
        total = total + weights[k]
    summed = qagg(q, s, torch.ones_like(weights))
    del q, s
    return summed.div_(total)
