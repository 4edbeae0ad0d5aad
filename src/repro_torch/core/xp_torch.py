"""A small PyTorch array namespace for the strategies' ``xp`` hooks.

``api/strategies.py`` writes its combines against an array namespace
(numpy on the host path, ``jax.numpy`` when compiled).  ``TorchXP(device)``
gives those hooks what they call, on torch tensors, so the copied
``combine_masked`` runs unchanged on the card.  Arrays are ``XArray``, a
tensor subclass that adds numpy's ``astype``; every torch op on one returns
one.

Where the order of floating-point work decides the bits, it is fixed to the
one ``jax.numpy`` uses on the CPU:

* ``sort``/``argsort`` are stable (ties keep their row order, ``-0.0`` and
  ``0.0`` are ties), as ``jnp.sort``/``jnp.argsort`` are.  They run as an
  odd-even transposition network of compare-exchanges between neighbouring
  rows, which is a stable sort and costs a few elementwise passes for the
  handful of clients a round has; ``torch.sort`` over a (K, n) chunk would
  sort n segments of K.
* ``sum`` and ``cumsum`` along an axis add the rows one after another
  starting from 0, as XLA's CPU reduction does.
"""
from __future__ import annotations

import torch


class XArray(torch.Tensor):
    """A tensor with numpy's ``astype``."""

    def astype(self, dtype):
        return self.to(_dtype(dtype))


class _DType:
    """A dtype of the namespace: passed where numpy takes a dtype, or
    called to make a 0-d array (``xp.float32(3.0e38)``)."""

    def __init__(self, dtype: torch.dtype, device):
        self.torch, self.device = dtype, device

    def __call__(self, value):
        return torch.tensor(value, dtype=self.torch,
                            device=self.device).as_subclass(XArray)


def _dtype(d):
    return d.torch if isinstance(d, _DType) else d


def _x(t: torch.Tensor) -> XArray:
    return t.as_subclass(XArray)


def _moveaxis_to_0(fn, x, axis):
    """Apply ``fn`` (which works along axis 0) along ``axis``."""
    if axis in (0, -x.dim()):
        return fn(x)
    return fn(x.movedim(axis, 0)).movedim(0, axis)


def _network(x: torch.Tensor, idx=None):
    """Stable ascending sort along axis 0 by odd-even transposition: K
    rounds of compare-exchanges between neighbouring rows, a swap only
    where the upper row is strictly greater.  Carries ``idx`` along."""
    rows = list(x.unbind(0))
    ids = list(idx.unbind(0)) if idx is not None else None
    n = len(rows)
    for rnd in range(n):
        for i in range(rnd % 2, n - 1, 2):
            a, b = rows[i], rows[i + 1]
            swap = a > b
            rows[i], rows[i + 1] = torch.where(swap, b, a), \
                torch.where(swap, a, b)
            if ids is not None:
                ia, ib = ids[i], ids[i + 1]
                ids[i], ids[i + 1] = torch.where(swap, ib, ia), \
                    torch.where(swap, ia, ib)
    out = torch.stack(rows)
    return out if ids is None else (out, torch.stack(ids))


class TorchXP:
    """The namespace on one device."""

    inf = float("inf")

    def __init__(self, device):
        self.device = torch.device(device)
        for name in ("float32", "int32"):
            setattr(self, name, _DType(getattr(torch, name), self.device))

    # -- construction -----------------------------------------------------
    def asarray(self, x, dtype=None):
        t = torch.as_tensor(x, device=self.device)
        if dtype is not None:
            t = t.to(_dtype(dtype))
        return _x(t)

    def arange(self, n):
        return _x(torch.arange(n, device=self.device))

    def eye(self, n, dtype=None):
        return _x(torch.eye(n, dtype=_dtype(dtype) or torch.float32,
                            device=self.device))

    def zeros_like(self, x):
        return _x(torch.zeros_like(x))

    def broadcast_to(self, x, shape):
        return _x(x.expand(shape))

    # -- elementwise ------------------------------------------------------
    def _t(self, v, like):
        return v if torch.is_tensor(v) else torch.tensor(
            v, dtype=like.dtype, device=like.device)

    def where(self, cond, a, b):
        return _x(torch.where(cond, a, b))

    def maximum(self, a, b):
        a = self._t(a, b)
        return _x(torch.maximum(a, self._t(b, a)))

    def minimum(self, a, b):
        a = self._t(a, b)
        return _x(torch.minimum(a, self._t(b, a)))

    def clip(self, x, lo=None, hi=None):
        return _x(torch.clamp(x, lo, hi))

    def floor(self, x):
        return _x(torch.floor(x))

    # -- reductions -------------------------------------------------------
    def sum(self, x, axis=None, keepdims=False):
        if axis is None:
            return _x(torch.sum(x))
        acc = torch.zeros_like(x.select(axis, 0))
        for row in x.unbind(axis):
            acc = acc + row
        return _x(acc.unsqueeze(axis) if keepdims else acc)

    def cumsum(self, x, axis=0):
        def rows(t):
            out, acc = [], torch.zeros_like(t[0])
            for row in t.unbind(0):
                acc = acc + row
                out.append(acc)
            return torch.stack(out)
        return _x(_moveaxis_to_0(rows, x, axis))

    def argmax(self, x, axis=0):
        if x.dtype != torch.bool:
            return _x(torch.argmax(x, dim=axis))
        # the first True along the axis (0 where there is none): one select
        # a row, from the last row up
        rows = x.unbind(axis)
        idx = torch.zeros(rows[0].shape, dtype=torch.int64, device=x.device)
        for i in range(len(rows) - 1, -1, -1):
            idx = torch.where(rows[i], i, idx)
        return _x(idx)

    # -- sorting and gathering --------------------------------------------
    def sort(self, x, axis=-1):
        return _x(_moveaxis_to_0(_network, x, axis))

    def argsort(self, x, axis=-1):
        def order(t):
            idx = torch.arange(t.shape[0], device=t.device).view(
                (-1,) + (1,) * (t.dim() - 1)).expand(t.shape)
            return _network(t, idx)[1]
        return _x(_moveaxis_to_0(order, x, axis))

    def take(self, x, i, axis=0):
        i = torch.as_tensor(i, device=x.device).reshape(1).long()
        return _x(torch.index_select(x, axis, i).squeeze(axis))

    def take_along_axis(self, x, idx, axis):
        return _x(torch.take_along_dim(x, idx.long(), dim=axis))
