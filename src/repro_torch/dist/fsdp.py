"""FSDP over the mesh's ``data`` axis inside a client (the ``shared`` mode),
for every family.

The reference has no file for this: in ``shared`` mode its rules put the
``embed`` dim of every parameter on ``data`` (``dist/sharding.rules_for``)
and one FL client on each ``pod``, and GSPMD gathers the weights where the
math needs them and reduce-scatters their gradients.  Here that is written
out over the process group of the client's D data ranks
(``launch.mesh.Mesh.group("data")``), as ``dist/tensor_parallel.py``
writes out the ``model`` axis:

* a leaf whose spec puts a dim on ``data`` is gathered whole along it
  where it is used (``gather_from_data``: an all-gather forward), inside
  the layer function that ``checkpoint`` wraps, so remat gathers again in
  the backward and no layer's whole weights outlive the layer.  The
  gathered leaf is still split on ``model``, so the tensor-parallel code
  runs on it unchanged;
* the client's batch splits over ``data`` where its size B divides D, data
  rank d taking rows ``d*B/D .. (d+1)*B/D`` (``models/inputs.rank_rows``,
  the reference's ``batch_specs`` rule), and otherwise every data rank
  takes the whole batch;
* under a split batch each rank's loss is the mean over its rows, and the
  gradients are those of the mean of the D ranks' losses, which is the
  client's loss: a gathered leaf's gradient is reduce-scattered in f32 and
  divided by D (``gather_from_data``'s backward), and a leaf with no dim
  on ``data`` (the norms) has its gradient all-reduced in f32 and divided
  by D (``reduce_replicated``).  Under a replicated batch every rank's
  gradient is already the whole one: a gathered leaf keeps its slice, and
  nothing is summed;
* the MoE layer routes the client's whole batch (its capacity and its
  auxiliary loss are over all B x S tokens): under a split batch each
  rank gathers its rows' activations over the data group
  (``gather_rows``: an all-gather forward, a reduce-scatter of the
  gradient backward, unscaled, since every rank's backward then is that of
  the sum of the D ranks' losses), runs the layer on the whole batch and
  keeps its own rows.  The auxiliary loss is equal on the D ranks, so the
  mean of their losses counts it once.

Every collective runs in f32 where it sums, and rounds to the leaf's or
activation's dtype once after the sum.  Adafactor's means over a dim on
``data`` sum over the data group (``optim/api.adafactor``).  Leaves used
outside a layer are gathered where they are used: the embedding tables,
the encoder-decoder's ``enc_in`` and the VLM's patch projection.
"""
from __future__ import annotations

import copy
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.dist.tensor_parallel import GroupAxis

class DataAxis(GroupAxis):
    """A client's data axis as the decoder sees it: the process group of
    its D ranks, this rank's index ``rank`` in it, ``dims`` (leaf path name
    of one client's parameters -> the dim its spec puts on ``data``), and
    ``split``, whether the batch the axis's client trains on is split over
    the ranks (``models/inputs.rank_rows``; the gradients' reductions
    follow it)."""

    def __init__(self, group, size: int, rank: int, dims: dict,
                 split: bool = True):
        super().__init__(group, size, rank)
        self.dims, self.split = dims, split

    def with_split(self, split: bool) -> "DataAxis":
        """This axis for a batch that is split (or not): a copy sharing
        the group and the ``events`` list."""
        out = copy.copy(self)
        out.split = split
        return out

    def reduce_scatter_f32(self, g: torch.Tensor, dim: int) -> torch.Tensor:
        """``g`` (whole along ``dim``) summed over the data group in f32,
        and this rank's 1/D of the sum along ``dim`` (a new f32 tensor)."""
        whole = g.movedim(dim, 0).to(torch.float32, copy=True).contiguous()
        out = whole.new_empty((whole.shape[0] // self.size,)
                              + whole.shape[1:])

        def scatter():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", FutureWarning)
                dist.reduce_scatter_tensor(out, whole, group=self.group)
        self._timed(g, scatter)
        return out.movedim(0, dim)

    def mean_f32(self, g: torch.Tensor) -> torch.Tensor:
        """``g`` averaged over the data group in f32, cast back."""
        return self.sum_f32(g).div_(self.size).to(g.dtype)


class _GatherFromData(torch.autograd.Function):
    """A leaf's blocks concatenated along its ``data`` dim.  Backward, under
    a split batch: the gradient reduce-scattered in f32 and divided by D,
    cast to the leaf's dtype (the gradient of the mean of the ranks'
    losses); under a replicated batch, this rank's slice of the gradient,
    which is whole and equal on every rank."""

    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim, ctx.n, ctx.dtype = axis, dim, t.shape[dim], t.dtype
        return axis.all_gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        if not axis.split:
            return g.narrow(ctx.dim, axis.rank * ctx.n, ctx.n), None, None
        part = axis.reduce_scatter_f32(g, ctx.dim)
        return part.div_(axis.size).to(ctx.dtype), None, None


class _GatherRows(torch.autograd.Function):
    """Every data rank's rows of an activation, concatenated along dim 0;
    the backward reduce-scatters the gradient in f32 (the sum over the
    ranks' backwards, unscaled) and casts it to the activation's dtype."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.dtype = axis, x.dtype
        return axis.all_gather(x, 0)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.reduce_scatter_f32(g, 0).to(ctx.dtype), None


def gather_from_data(t: torch.Tensor, axis: DataAxis,
                     dim: int) -> torch.Tensor:
    return _GatherFromData.apply(t, axis, dim)


def gather_rows(x: torch.Tensor, axis: DataAxis) -> torch.Tensor:
    return _GatherRows.apply(x, axis)


def own_rows(y: torch.Tensor, axis: DataAxis) -> torch.Tensor:
    """This rank's rows (dim 0) of an activation over the whole batch."""
    n = y.shape[0] // axis.size
    return y.narrow(0, axis.rank * n, n)


def whole(axis: Optional[DataAxis], tree, prefix: str, lead: int = 0):
    """``tree`` (the parameters under path ``prefix``) with every leaf
    that has a dim on ``data`` gathered whole along it; ``lead`` is the
    number of leading dims the leaves have lost against their path's spec
    (1 for a layer's view of a stacked leaf).  Without an axis, ``tree``."""
    if axis is None:
        return tree
    out = []
    for path, t in T.leaves_with_path(tree):
        d = axis.dims.get("/".join((prefix,) + path) if path else prefix)
        out.append(t if d is None else gather_from_data(t, axis, d - lead))
    return T.unflatten_like(tree, out)


def reduce_replicated(grads: list, names: list, axis: DataAxis) -> list:
    """Under a split batch, the gradient of every leaf with no dim on
    ``data`` (path names ``names``) averaged over the data group in f32:
    the gradient of the mean of the ranks' losses.  Under a replicated
    batch, ``grads`` as they are."""
    if not axis.split:
        return grads
    return [g if n in axis.dims else axis.mean_f32(g)
            for g, n in zip(grads, names)]


def data_dims(specs) -> dict:
    """Leaf path name -> the dim its spec (one client's, no client dim)
    puts on ``data``, for the leaves that have one."""
    return {"/".join(path): s.index("data")
            for path, s in T.leaves_with_path(specs) if "data" in s}
