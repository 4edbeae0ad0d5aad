"""Logical-axis parameter declarations and their initialization.

Models declare parameters as ``decl(shape, logical_axes)`` trees instead of
concrete tensors.  Stacked axes ("layers" from ``stack``, "clients" from
``prepend_axis``) are excluded from fan-in when initializing, so a stacked
layer initializes exactly like an unstacked one.

Mesh rules and ``specs_for`` wait for the multi-GPU slice; on one device
every leaf lives whole on the card.
"""
from __future__ import annotations

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


def _init_leaf(d: ParamDecl, gen: torch.Generator, device):
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init == "neg_ones":
        return torch.full(d.shape, -1, dtype=d.dtype, device=device)
    if d.init == "const":
        return torch.full(d.shape, d.scale, dtype=d.dtype, device=device)
    if d.init == "embed":
        std = 0.02 * d.scale
    elif d.init == "normal":
        std = d.scale / math.sqrt(_fan_in(d))
    else:
        raise ValueError(f"unknown init {d.init!r}")
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(d.dtype)


def materialize(tree, seed: int, device):
    """Concrete tensors for a decl tree.  Deterministic: leaf ``i`` draws
    from its own ``torch.Generator`` seeded with ``(seed, i)``.  The draws
    differ from ``jax.random``'s; the statistics are the same."""
    device = torch.device(device)
    out = []
    for i, d in enumerate(T.leaves(tree)):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed * 1_000_003 + i)
        out.append(_init_leaf(d, gen, device))
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
