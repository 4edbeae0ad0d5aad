"""Op-by-op cost of one eager step: the counterpart of the reference's
``launch/hlo_analysis.py``.

The reference parses the partitioned HLO of a compiled step and prices its
dots, its materializing ops and its collectives.  Here the step runs
eagerly, on meta tensors in a dry run (``launch/dryrun.py``) or on the
card, under ``OpCounter``, a ``TorchDispatchMode`` that sees every aten and
``c10d`` op the step dispatches:

  * FLOPs        — of each aten op that ``torch.utils.flop_counter`` has a
                   formula for (matmuls, convolutions, SDPA), from its
                   shapes;
  * HBM bytes    — each tensor argument and each result of every aten op
                   that is not a view, an allocation or a host read, at its
                   logical size.  This is the eager count: eager PyTorch
                   writes every op's result to memory and reads it back,
                   where XLA's fusions keep elementwise chains on chip, so
                   it exceeds what a fused program moves;
  * collective wire bytes — of each ``c10d`` collective by the reference's
                   ring rule (``hlo_analysis.py``): an all-reduce 2(g-1)/g
                   of its buffer, an all-gather or reduce-scatter (g-1)/g
                   of the larger side, a broadcast the buffer, g the op's
                   group size.  A group whose ranks lie on more than one
                   node of ``NODE_SIZE`` cards is priced across nodes;
  * the hand-written kernels — their launches (and, in a dry run, the meta
                   calls that stand for them) report each its ``ops.cost()``
                   (``kernels/_build.record``), by kernel.

An eager trace runs every layer and chunk, so there are no loop trip
counts to recover (the reference's ``while_trips``).  ``LiveBytes`` tracks
the bytes of the storages alive while a step runs, from its arguments'
up to its peak: the counterpart of ``memory_analysis()``.  Every number is
one rank's.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build
from repro_torch.launch.mesh import NODE_SIZE

aten = torch.ops.aten

# ops that move no memory: allocations (their storage is written by the op
# that fills it) and aliases
_NO_TRAFFIC = {aten.empty, aten.empty_strided, aten.empty_like,
               aten.new_empty, aten.new_empty_strided, aten.lift_fresh,
               aten._unsafe_view, aten.detach, aten.alias}
# a host's read of a scalar (``float(x)``): a sync with no device work,
# which a meta trace cannot run, so it is not counted
_UNCOUNTED = {aten._local_scalar_dense}

# the c10d ops of the collectives the port calls -> (the reference's HLO
# name of the collective, the wire factor of the group size g); any other
# c10d op is counted by name in ``op_counts``
_COLLECTIVES = {
    "allreduce_": ("all-reduce", lambda g: 2.0 * (g - 1) / g),
    "_allgather_base_": ("all-gather", lambda g: (g - 1) / g),
    "_reduce_scatter_base_": ("reduce-scatter", lambda g: (g - 1) / g),
    "broadcast_": ("broadcast", lambda g: 1.0),
}


def _tensors(x) -> list:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class OpCost:
    """One rank's cost of a step (``hlo_analysis.HLOCost``'s fields, with
    the cross-node bytes in place of the cross-pod ones, and by kernel)."""
    flops: float = 0.0                 # aten FLOPs + the kernels'
    hbm_bytes: float = 0.0             # aten bytes + the kernels'
    coll_bytes: float = 0.0            # wire bytes, every collective
    coll_cross_node_bytes: float = 0.0
    coll_per_op: dict = field(default_factory=dict)      # kind -> wire bytes
    coll_counts: dict = field(default_factory=dict)      # kind -> ops
    hbm_per_op: dict = field(default_factory=dict)       # op -> bytes
    # "<kind>/<group size>" -> {"count", "bytes"}: the wire bytes by group
    coll_by_group: dict = field(default_factory=dict)
    # kernel -> {"launches", "flops", "bytes"}
    kernels: dict = field(default_factory=dict)
    op_counts: dict = field(default_factory=dict)        # op -> calls

    def to_dict(self) -> dict:
        return dict(self.__dict__)


def _group_of(func, args, kwargs):
    """The process group a ``c10d`` op runs in, from its schema."""
    for i, a in enumerate(func._schema.arguments):
        if a.name == "process_group":
            pg = args[i] if i < len(args) else kwargs[a.name]
            return dist.ProcessGroup.unbox(pg)
    raise ValueError(f"{func}: no process group argument")


class OpCounter(TorchDispatchMode):
    """Counts one rank's FLOPs, HBM bytes, collectives and kernel calls of
    everything dispatched while it is active (module docstring) into
    ``self.cost``.  A group spanning nodes of ``NODE_SIZE`` cards is
    priced across them."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()

    def __enter__(self):
        _build.counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.counters.remove(self)
        return super().__exit__(*exc)

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One call of a hand-written kernel (``_build.record``)."""
        c, k = self.cost, self.cost.kernels.setdefault(
            name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        c.flops += flops
        c.hbm_bytes += nbytes

    def _collective(self, func, args, kwargs, out):
        kind, factor = _COLLECTIVES[func._overloadpacket.__name__]
        pg = _group_of(func, args, kwargs)
        ranks = dist.get_process_group_ranks(pg)
        g = len(ranks)
        ins = _tensors(args)
        outs = _tensors(out)
        size = sum(_nbytes(t) for t in outs)
        if kind in ("all-gather", "reduce-scatter"):
            size = max(size, sum(_nbytes(t) for t in ins) - size)
        wire = factor(g) * size if g > 1 else 0.0
        c = self.cost
        c.coll_bytes += wire
        c.coll_per_op[kind] = c.coll_per_op.get(kind, 0.0) + wire
        c.coll_counts[kind] = c.coll_counts.get(kind, 0) + 1
        key = f"{kind}/{g}"
        row = c.coll_by_group.setdefault(key, {"count": 0, "bytes": 0.0})
        row["count"] += 1
        row["bytes"] += wire
        if len({r // NODE_SIZE for r in ranks}) > 1:
            c.coll_cross_node_bytes += wire
        res = sum(_nbytes(t) for t in outs)
        c.hbm_bytes += res
        c.hbm_per_op[kind] = c.hbm_per_op.get(kind, 0.0) + res

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in _UNCOUNTED:
            return out
        if func.namespace == "c10d" and packet.__name__ in _COLLECTIVES:
            self._collective(func, args, kwargs, out)
            return out
        c = self.cost
        name = str(packet) if func.namespace == "c10d" else packet.__name__
        c.op_counts[name] = c.op_counts.get(name, 0) + 1
        if packet in flop_registry:
            # the formulas take the default overload's arguments: drop a
            # ``.dtype`` overload's out_dtype (``mm(a, b, out_dtype=)``)
            fargs = tuple(a for a, s in zip(args, func._schema.arguments)
                          if s.name != "out_dtype")
            c.flops += float(flop_registry[packet](*fargs, **kwargs,
                                                   out_val=out))
        if func.namespace != "aten" or func.is_view or packet in _NO_TRAFFIC:
            return out
        b = float(sum(_nbytes(t) for t in _tensors((args, kwargs)))
                  + sum(_nbytes(t) for t in _tensors(out)))
        c.hbm_bytes += b
        c.hbm_per_op[name] = c.hbm_per_op.get(name, 0.0) + b
        return out


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages alive while a step runs: those of
    ``arguments`` (its inputs), then every storage an op returns, until it
    is freed.  ``arguments`` is the inputs' total and ``peak`` the most
    alive after any op, inputs included: what a caching allocator's
    ``max_memory_allocated`` reads, short of its rounding and the
    libraries' workspaces."""

    def __init__(self, arguments=()):
        super().__init__()
        self._live: dict = {}
        self.now = 0
        for t in _tensors(arguments):
            self._add(t)
        self.arguments = self.peak = self.now

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.now += n
        weakref.finalize(st, self._drop, key)

    def _drop(self, key) -> None:
        self.now -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            self._add(t)
        self.peak = max(self.peak, self.now)
        return out
