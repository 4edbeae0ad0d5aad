"""Logical-axis parameter declarations, their initialization, and the
resolver from logical axes to mesh axes.

Models declare parameters as ``decl(shape, logical_axes)`` trees instead of
concrete tensors.  Stacked axes ("layers" from ``stack``, "clients" from
``prepend_axis``) are excluded from fan-in when initializing, so a stacked
layer initializes exactly like an unstacked one.

``rules_for``/``specs_for`` are the reference's resolver as pure functions
of the decls and a mesh shape (``{"data": 4, "model": 1}``, or a
``launch.mesh.Mesh``): a spec is a tuple of mesh-axis names (None where a
dim is whole), equal to the reference's ``PartitionSpec``.  The reference's
``shardings_for`` has no counterpart: torch has no ``NamedSharding``.  A
rank takes its block of a tensor with ``local_block``: along every dim
whose spec names a mesh axis, its part of that axis, from its coordinates
in the (pod, data, model) grid (``mesh_coords``: rank ``(p * D + d) * M +
m``).  In ``replica`` mode that is its client's slot along the dim the
``clients`` spec puts on ``data`` and its 1/M along every dim on ``model``
(tensor parallelism, ``dist/tensor_parallel.py``); in ``shared`` mode its
pod's slot, its 1/D of the ``embed`` dim (FSDP, ``dist/fsdp.py``) and its
1/M of the dims on ``model``.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch import tree as T

# Leading axes added by stack()/prepend_axis(): not part of a weight's
# mathematical shape, excluded from fan-in.
_STACK_AXES = ("layers", "clients")


@dataclass(frozen=True)
class ParamDecl:
    """One declared parameter: shape + logical axis names + init recipe."""
    shape: tuple
    axes: tuple
    init: str = "normal"        # normal | embed | zeros | ones | neg_ones | const
    dtype: Any = torch.bfloat16
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    @property
    def size(self) -> int:
        return int(math.prod(self.shape)) if self.shape else 1


def decl(shape, axes, init: str = "normal", dtype=torch.bfloat16,
         scale: float = 1.0) -> ParamDecl:
    return ParamDecl(tuple(shape), tuple(axes), init, dtype, float(scale))


def is_decl(x) -> bool:
    return isinstance(x, ParamDecl)


def stack(tree, n: int):
    """Prepend a loop-over-layers dim to every decl in the tree."""
    return prepend_axis(tree, n, "layers")


def prepend_axis(tree, n: int, name: str):
    """Prepend a named leading dim (e.g. "clients") to every decl."""
    return T.tree_map(
        lambda d: ParamDecl((n,) + d.shape, (name,) + d.axes,
                            d.init, d.dtype, d.scale), tree)


def param_count(tree) -> int:
    return sum(d.size for d in T.leaves(tree))


# --------------------------------------------------------------------------
# Initialization
# --------------------------------------------------------------------------

def _fan_in(d: ParamDecl) -> int:
    """Product of contracting dims: everything but the last, excluding
    stacked leading axes."""
    f = 1
    for dim, ax in zip(d.shape[:-1], d.axes[:-1]):
        if ax not in _STACK_AXES:
            f *= dim
    return max(f, 1)


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _layer_seed(seed: int, leaf: int, layer: int) -> int:
    """The seed of layer ``layer``'s slice of stacked leaf ``leaf``: a hash
    of the three, so no two slices (nor an unstacked leaf's
    ``seed * 1_000_003 + leaf``, in practice) share a stream."""
    h = hashlib.blake2b(f"{seed}/{leaf}/{layer}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def _std(d: ParamDecl) -> float:
    if d.init == "embed":
        return 0.02 * d.scale
    if d.init == "normal":
        return d.scale / math.sqrt(_fan_in(d))
    raise ValueError(f"unknown init {d.init!r}")


def _init_layers(d: ParamDecl, seed: int, i: int, device, block=None):
    """Stacked leaf ``d`` (leading axis ``layers``), one layer at a time:
    layer l's slice is drawn from its own generator (``_layer_seed``), and
    only its part under ``block`` is kept, so the f32 transient is one
    layer's slice and a rank's part equals the whole leaf's."""
    L, std = d.shape[0], _std(d)
    if block is None:
        kept = list(range(L))
        out = torch.empty(d.shape, dtype=d.dtype, device=device)
    else:
        # the layers the block keeps: its part of a tensor holding each
        # element's layer index (an expanded view: nothing allocated)
        ids = torch.arange(L).view((L,) + (1,) * (len(d.shape) - 1))
        ids = block(ids.expand(d.shape))
        kept = ids[(slice(None),) + (0,) * (ids.dim() - 1)].tolist()
        out = torch.empty(ids.shape, dtype=d.dtype, device=device)
    for p, layer in enumerate(kept):
        x = torch.randn(d.shape[1:], generator=_generator(
            _layer_seed(seed, i, layer), device), dtype=torch.float32,
            device=device)
        part = x if block is None else block(x.expand(d.shape))[0]
        out[p].copy_(part.mul_(std) if block is None else part.mul(std))
    return out


def _init_leaf(d: ParamDecl, seed: int, i: int, device, block=None):
    """Leaf ``d`` (leaf ``i`` of its tree); ``block``, when given, maps the
    whole tensor to the part to keep (a view), taken before any
    elementwise step so the part's bits are the whole's.  A leaf stacked
    over ``layers`` is drawn one layer at a time (``_init_layers``); any
    other is drawn whole from one generator seeded with
    ``seed * 1_000_003 + i``."""
    if d.init in ("zeros", "ones", "neg_ones", "const"):
        shape = d.shape if block is None else \
            block(torch.empty(d.shape, device="meta")).shape
        fill = {"zeros": 0, "ones": 1, "neg_ones": -1}.get(d.init, d.scale)
        return torch.full(shape, fill, dtype=d.dtype, device=device)
    std = _std(d)
    if d.axes and d.axes[0] == "layers":
        return _init_layers(d, seed, i, device, block)
    x = torch.randn(d.shape, generator=_generator(seed * 1_000_003 + i,
                                                  device),
                    dtype=torch.float32, device=device)
    if block is None:
        return x.mul_(std).to(d.dtype)
    return block(x).mul_(std).to(d.dtype, copy=True)   # drops the whole


def materialize(tree, seed: int, device, block=None):
    """Concrete tensors for a decl tree.  Deterministic: leaf ``i`` draws
    from its own ``torch.Generator`` seeded from ``(seed, i)``, and a leaf
    stacked over ``layers`` draws each layer's slice from one seeded from
    ``(seed, i, layer)``.  The draws differ from ``jax.random``'s; the
    statistics are the same.

    ``block(i, t)``, when given, keeps a part of leaf i (a rank's block):
    a leaf is drawn whole (a stacked one a layer at a time), one leaf at a
    time, and only the part is kept, so the part equals that of the whole
    tree and the f32 transient is one leaf (one layer's slice)."""
    device = torch.device(device)
    out = []
    for i, d in enumerate(T.leaves(tree)):
        keep = (lambda x, i=i: block(i, x)) if block else None
        out.append(_init_leaf(d, seed, i, device, keep))
    return T.unflatten_like(tree, out)


def from_reference(np_tree, decls, device, dtype=None):
    """The JAX package's parameters (numpy leaves; bf16 leaves handed over
    as exact float32) as the port's tree, in each decl's dtype, or in
    ``dtype`` for every leaf when given (f32 parity runs)."""
    device = torch.device(device)

    def one(x, d):
        if tuple(np.shape(x)) != d.shape:
            raise ValueError(f"reference leaf of shape {np.shape(x)} does "
                             f"not match its decl {d.shape}")
        t = torch.from_numpy(np.array(x, dtype=np.float32))
        return t.to(device=device, dtype=dtype or d.dtype)
    return T.tree_map(one, np_tree, decls)


# --------------------------------------------------------------------------
# Logical-axis resolution
# --------------------------------------------------------------------------

def rules_for(mode: str) -> dict:
    """Logical axis -> mesh axis for an FL deployment mode.  The caller may
    override entries (fl_step sets rules["clients"])."""
    common = {
        "vocab": "model", "heads": "model", "kv_heads": "model",
        "mlp": "model", "experts": "model", "expert_mlp": "model",
        "layers": None, "clients": None,
        "batch": "data", "cache_seq": "model",
    }
    if mode == "shared":      # FSDP over data + TP over model
        return {**common, "embed": "data", "embed_tp": "data"}
    if mode == "replica":     # per-client replicas; TP over model only
        return {**common, "embed": None, "embed_tp": None}
    raise ValueError(f"unknown FL mode {mode!r}")


def mesh_shape(mesh) -> dict:
    """Axis name -> size, for a shape dict or a mesh object."""
    return mesh if isinstance(mesh, dict) else mesh.shape


def _spec_for(d: ParamDecl, rules: dict, mesh) -> tuple:
    """Scans dims left to right; a dim takes its rule's mesh axis when the
    axis exists, is not yet claimed by this tensor, and divides the dim."""
    sizes = mesh_shape(mesh)
    used: set = set()
    parts = []
    for dim, ax in zip(d.shape, d.axes):
        m = rules.get(ax) if ax is not None else None
        if (m is not None and m in sizes and m not in used
                and dim >= sizes[m] and dim % sizes[m] == 0):
            parts.append(m)
            used.add(m)
        else:
            parts.append(None)
    return tuple(parts)


def specs_for(tree, rules: dict, mesh):
    """Spec tree (tuples of mesh-axis names) for a decl tree."""
    return T.tree_map(lambda d: _spec_for(d, rules, mesh), tree)


def mesh_coords(mesh, rank: int) -> dict:
    """Axis -> index of ``rank`` in ``mesh`` (a shape dict or a mesh
    object), ``model`` the fastest axis: ``rank = (p * D + d) * M + m``."""
    sizes = mesh_shape(mesh)
    out, r = {}, rank
    for ax in reversed(list(sizes)):
        r, out[ax] = divmod(r, sizes[ax])
    return {ax: out[ax] for ax in sizes}


def local_block(t: torch.Tensor, spec: tuple, mesh,
                rank: int | None = None) -> torch.Tensor:
    """The block of the whole tensor ``t`` under ``spec`` that a rank of
    ``mesh`` holds (a view): along each dim that names an axis of the mesh,
    the rank's part of it, index ``p`` of P on ``pod``, ``d`` of D on
    ``data`` and ``m`` of M on ``model``, where ``rank = (p * D + d) * M +
    m`` (this rank's unless given)."""
    sizes = mesh_shape(mesh)
    at = mesh_coords(sizes, mesh.rank if rank is None else rank)
    for dim, ax in enumerate(spec):
        if ax in at and sizes[ax] > 1:
            n = t.shape[dim] // sizes[ax]
            t = t.narrow(dim, at[ax] * n, n)
    return t
