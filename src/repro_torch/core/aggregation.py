"""Aggregation data plane, on one device or across the ranks of a mesh.

The reference runs aggregation as compiled collectives over a client mesh
axis (one grouped psum per cluster level for ``tree``).  On one GPU the K
clients share the card, so for a ``sum`` strategy the ``tree``, ``flat``
and ``rs_ag`` schedules compute the same weighted K-way mean: ``tree``'s
per-level partial sums add up to the flat sum (``fedavg_tree_ref`` ==
``fedavg_ref``).  The mean is written back into every client slot, as the
reference's broadcast does.  Across ranks (``mesh=``, one client a rank,
see "Across ranks" below) the schedules are collectives, as in the
reference.

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

Across ranks (``aggregate_params(..., mesh=mesh)``), each rank passes its
own slot (leading dim 1) and the (K,) weights; the reference's
``shard_map`` body is the per-rank code.  The work goes per leaf and per
chunk of at most ``CHUNK`` elements, so no rank holds an f32 copy of its
whole slot (the reference's ``_weighted`` upcasts the whole tree).

* ``sum`` strategies: the rank's f32 contribution (premapped against its
  own pre-round slot where the strategy needs a ref) times its weight,
  then ``tree``: at level l > 0 times ``head_masks[l-1][rank]``, then an
  ``all_reduce`` in the rank's level-l group (``Mesh.subgroups``); ``flat``:
  one ``all_reduce``; ``rs_ag``: ``reduce_scatter_tensor`` +
  ``all_gather_into_tensor`` over the flattened chunk, padded to a
  multiple of the world size (the sum is elementwise, so this is the same
  sum as the reference's scatter along the largest divisible dim), with an
  ``all_reduce`` below ``4 x world`` elements.  The weight total goes
  through the same collectives; the sum is divided by it (a tensor, not a
  Python scalar) and cast.  Four terms summed in another order than the
  fedavg kernel's k = 0..K-1: within one rounding of the f32 sum.
* ``compressed``: the rank's weighted contribution is quantized per row
  (``quantize_int8``, plain, as in the reference), the int8 rows and their
  scales are all-gathered into a (K, rows, cols) block, one qagg launch a
  leaf with unit weights sums it, and the all-reduced weight total
  divides it: the single-card computation, bit for bit (for weights whose
  total is exact in f32, as sample counts are).
* ``stack`` strategies: each chunk (premapped locally) is all-gathered
  into a (K, chunk) block and the single-card combine runs on it; krum's
  Gram accumulates chunk by chunk over the gathered blocks.  Every rank
  computes the same combine, as the reference's replicated combine does,
  bit for bit the single card's.

A dead client's rank stays in every collective with weight 0, as its
mesh row does in the reference.

On a (data, model) mesh each rank holds its client's model block of every
leaf (``sharding.local_block``), and every collective above runs in its
``data`` group, the D ranks of its model column, on that block: the
reference's ``shard_map`` body, which sees the same block.  In ``shared``
mode (a (pod, data, model) mesh, one client a pod) the client axis is
``pod`` (``aggregate_params(..., axis="pod")``): each rank holds its pod's
(data, model) block, and the collectives run in its ``pod`` group, the P
ranks of that block; ``compressed`` quantizes the block's rows.  So the
strategies that reduce over a whole leaf or tree reduce over the block, as
the reference's do: multi_krum's norms and Gram (its choice of clients can
differ from shard to shard), norm_clip's norm, ``compressed``'s per-row
scales where the last dim is split.  Every rank of a column ends with the
same block.
"""
from __future__ import annotations

import warnings
from contextlib import contextmanager
from typing import Union

import torch
import torch.distributed as dist

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
                     ref=None, mesh=None, axis: str = "data"):
    """bank: client-stacked tree (leading dim = n_clients); weights:
    (n_clients,) f32 on the bank's device.  Every client slot is
    overwritten in place with the strategy's aggregate; returns ``bank``.

    ``ref`` (same structure as ``bank``) is the pre-round model, read by
    strategies with ``needs_ref``: each leaf's leading dim is n_clients
    (client k premaps against its own slot) or 1 (one model for all).  It
    may live on another device (a pinned host copy); chunks are brought to
    the bank's device as they are needed.

    With ``mesh`` (a ``launch.mesh.Mesh``), ``bank`` is this rank's block
    (its client's slot, leading dim 1, and its block of each leaf on the
    other axes) and the aggregate runs across the ranks of its line along
    the client axis ``axis`` (``"data"`` in ``replica`` mode, ``"pod"`` in
    ``shared`` mode, the reference's ``aggregate_params(..., axis)``);
    every rank calls it with the same weights and schedule."""
    strat = check_strategy(strategy)
    if schedule.kind not in ("tree", "flat", "rs_ag", "compressed"):
        raise NotImplementedError(
            f"schedule {schedule.kind!r} is not ported yet (see ROADMAP.md)")
    leaves = T.leaves(bank)
    refs = T.leaves(ref) if strat.needs_ref and ref is not None else None
    with torch.no_grad():
        values = _premap(strat, leaves, refs) if refs is not None else None
        if mesh is not None:
            _across_ranks(strat, leaves, weights, schedule, mesh, values,
                          axis)
        elif strat.reduction == "stack":
            rows = values or (lambda i, c0, c1: _flat(leaves[i])[:, c0:c1])
            if isinstance(strat, MultiKrum):
                _krum(strat, leaves, weights, rows)
            else:
                _stack(strat, leaves, weights, rows)
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


def _stack(strat, leaves, weights, rows):
    """The per-coordinate masked combine, chunk by chunk, of the (K, chunk)
    blocks ``rows(i, c0, c1)``, written into every slot of ``leaves``."""
    xp = TorchXP(leaves[0].device)
    w = xp.asarray(weights)
    for i, leaf in enumerate(leaves):
        flat = _flat(leaf)
        for c0, c1 in _chunks(flat.shape[1]):
            out = strat.combine_masked({"x": xp.asarray(rows(i, c0, c1))},
                                       w, xp)["x"]
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


def _krum(strat: MultiKrum, leaves, weights, rows):
    """krum / multi_krum: ``MultiKrum.combine_masked`` with its flat rows'
    squared norms and Gram accumulated leaf by leaf and chunk by chunk over
    the (K, chunk) blocks ``rows(i, c0, c1)`` (concatenating the rows would
    copy the whole bank in f32)."""
    dev = leaves[0].device
    xp = TorchXP(dev)
    n = weights.shape[0]
    sq = torch.zeros((n,), dtype=torch.float32, device=dev)
    gram = torch.zeros((n, n), dtype=torch.float32, device=dev)
    with _full_f32_matmul():
        for i, leaf in enumerate(leaves):
            for c0, c1 in _chunks(leaf[0].numel()):
                X = rows(i, c0, c1).float()
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
            s = xp.asarray(rows(i, c0, c1).float())
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


# --------------------------------------------------------------------------
# across the ranks of a mesh
# --------------------------------------------------------------------------

def _gather_into(out: torch.Tensor, x: torch.Tensor, group=None):
    """``out`` (group size * x.numel() elements) <- every rank's ``x`` in
    ``group`` (the default group when None), in rank order.
    ``all_gather_into_tensor`` is in every torch this port runs on; newer
    ones warn that it is deprecated."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)


def _rs_ag(x: torch.Tensor, world: int, group=None):
    """In-place sum of the contiguous f32 ``x`` over the ``world`` ranks of
    ``group`` as a reduce-scatter and an all-gather of the flattened
    tensor, padded to a multiple of ``world``; an all-reduce below
    ``4 x world`` elements."""
    n = x.numel()
    if n < 4 * world:
        dist.all_reduce(x, group=group)
        return
    m = -(-n // world)
    flat = x.view(-1)
    buf = flat if m * world == n else torch.cat(
        [flat, flat.new_zeros(m * world - n)])
    part = buf.new_empty(m)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(part, buf, group=group)
    _gather_into(buf, part, group)
    if buf is not flat:
        flat.copy_(buf[:n])


def _sum(x: torch.Tensor, schedule: AggSchedule, mesh,
         axis: str) -> torch.Tensor:
    """``x`` (contiguous f32) summed in place over the rank's group along
    the client axis ``axis`` as ``schedule`` lays the collectives out;
    returns ``x``."""
    if schedule.kind == "tree":
        me = mesh.coord(axis)
        for lvl, group in enumerate(mesh.subgroups(schedule.level_groups,
                                                   axis)):
            if lvl > 0:          # above level 0 only the heads contribute
                x.mul_(float(schedule.head_masks[lvl - 1][me]))
            if group is not None:
                dist.all_reduce(x, group=group)
    elif schedule.kind == "rs_ag":
        _rs_ag(x, mesh.shape[axis], mesh.group(axis))
    else:                        # flat; compressed's weight total
        dist.all_reduce(x, group=mesh.group(axis))
    return x


def _gathered_rows(x: torch.Tensor, world: int, group=None) -> torch.Tensor:
    """Every rank's (1, n) ``x`` in ``group`` (``world`` ranks) stacked in
    rank order: (world, n)."""
    out = x.new_empty((world, x.shape[1]))
    _gather_into(out, x, group)
    return out


def _across_ranks(strat, leaves, weights, schedule, mesh, values, axis):
    """``aggregate_params`` on this rank's block (see the module's "Across
    ranks") along the client axis ``axis``."""
    K, group = mesh.shape[axis], mesh.group(axis)
    if weights.shape != (K,):
        raise ValueError(f"weights {tuple(weights.shape)} on a {axis} axis "
                         f"of {K}")
    if strat.reduction == "stack":
        local = values or (lambda i, c0, c1: _flat(leaves[i])[:, c0:c1])
        rows = lambda i, c0, c1: _gathered_rows(local(i, c0, c1), K, group)
        if isinstance(strat, MultiKrum):
            _krum(strat, leaves, weights, rows)
        else:
            _stack(strat, leaves, weights, rows)
        return
    me = mesh.coord(axis)
    w = weights[me:me + 1].float()
    total = _sum(w.clone(), schedule, mesh, axis)
    for i, leaf in enumerate(leaves):
        cols = (lambda c0, c1, i=i: values(i, c0, c1)) if values else None
        if schedule.kind == "compressed":
            _write(leaf, _gathered_mean(leaf, w, total, K, cols, group))
            continue
        flat = _flat(leaf)
        for c0, c1 in _chunks(flat.shape[1]):
            v = cols(c0, c1) if cols else flat[:, c0:c1].float()
            flat[:, c0:c1].copy_(_sum(v * w, schedule, mesh,
                                      axis).div_(total))


def _gathered_mean(leaf: torch.Tensor, w: torch.Tensor, total: torch.Tensor,
                   K: int, cols=None, group=None) -> torch.Tensor:
    """``_compressed_mean`` across the K ranks of ``group``: this rank's
    weighted contribution quantized per row, the int8 rows and scales of
    all of them gathered into (K, rows, cols), one qagg launch with unit
    weights, divided by the weight total."""
    G = leaf.shape[-1] if leaf.dim() > 1 else 1
    flat = _flat(leaf)
    R = flat.shape[1] // G
    q = torch.empty((K, R, G), dtype=torch.int8, device=leaf.device)
    s = torch.empty((K, R, 1), dtype=torch.float32, device=leaf.device)
    for c0, c1 in _chunks(R * G, max(1, CHUNK // G) * G):
        v = cols(c0, c1) if cols else flat[:, c0:c1].float()
        qr, sr = quantize_int8(v.view(1, -1, G) * w)
        rows = slice(c0 // G, c1 // G)
        if rows.stop - rows.start == R:          # the leaf in one chunk
            _gather_into(q, qr, group)
            _gather_into(s, sr, group)
        else:
            q[:, rows] = _gathered_rows(qr.view(1, -1), K, group).view(
                K, -1, G)
            s[:, rows] = _gathered_rows(sr.view(1, -1), K, group).view(
                K, -1, 1)
    summed = qagg(q, s, torch.ones((K,), dtype=torch.float32,
                                   device=leaf.device))
    del q, s
    return summed.div_(total)
