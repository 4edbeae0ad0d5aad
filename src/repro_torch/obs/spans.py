"""The data plane's spans: the ranges and CUDA-event pairs that the round
step and the model record, for a profiler's trace and for the trainer's
metrics.  (The rest of ``repro_torch.obs`` is the control plane's opt-in
telemetry; this module is apart from it.)

* ``record_function`` ranges named ``fl/...`` on the host share the
  profiler's clock with the device trace: a kernel belongs to the ranges
  open when the host launched it.
* ``block`` is such a range around one block of the model in the forward,
  followed into autograd's backward.  The block's input and its outputs
  go through identity ``Function``\\ s: the outputs' backward opens a
  range of the same name on the thread that runs the backward (autograd's
  device thread on a card), the input's backward closes it.  So the
  block's backward work sits under its name, and under remat the
  recompute it sets off runs the forward's ranges again inside it.  The
  marks save no tensor, build no node where grad is off, and pass the
  gradients through untouched.  Where no gradient reaches a block's input
  (a frozen base below it), the range is left to ``close_open``, which the
  round step calls at the end of its backward.
* ``span`` records a CUDA event pair around a stretch of the round step;
  ``span_ms`` reads the pairs once the round has been waited for.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
from torch.profiler import record_function

_open: list = []          # the backward ranges open now (``_Range``)


class _Range:
    """The backward range of one call of a block."""

    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name, self.rec = name, None

    def open(self):
        self.rec = record_function(self.name)
        self.rec.__enter__()
        _open.append(self)

    def close(self):
        if self.rec is not None:
            self.rec.__exit__(None, None, None)
            self.rec = None
            _open.remove(self)


class _OutMark(torch.autograd.Function):
    """Identity on a block's outputs; its backward opens the range."""

    @staticmethod
    def forward(ctx, rng, *ys):
        ctx.rng = rng
        ctx.set_materialize_grads(False)
        return ys

    @staticmethod
    def backward(ctx, *grads):
        ctx.rng.open()
        return (None,) + grads


class _InMark(torch.autograd.Function):
    """Identity on a block's input; its backward closes the range."""

    @staticmethod
    def forward(ctx, rng, x):
        ctx.rng = rng
        ctx.set_materialize_grads(False)
        return x

    @staticmethod
    def backward(ctx, g):
        ctx.rng.close()
        return None, g


def block(name: str, fn, x: torch.Tensor, *args):
    """``fn(x, *args)`` (a tensor or a tuple) under the range ``name``;
    where grad is on, its backward from its outputs' gradients down to
    ``x``'s runs under ``name`` too."""
    rng = _Range(name) if torch.is_grad_enabled() else None
    with record_function(name):
        if rng is not None and x.requires_grad:
            x = _InMark.apply(rng, x)
        out = fn(x, *args)
        if rng is None:
            return out
        outs = list(out) if isinstance(out, tuple) else [out]
        at = [i for i, y in enumerate(outs)
              if torch.is_tensor(y) and y.requires_grad]
        if at:
            for i, y in zip(at, _OutMark.apply(rng, *(outs[i] for i in at))):
                outs[i] = y
        return tuple(outs) if isinstance(out, tuple) else outs[0]


def close_open():
    """Closes every block's backward range still open: those whose input
    received no gradient."""
    while _open:
        _open[-1].close()


@contextmanager
def span(spans: dict, name: str, dev: torch.device):
    """On the card, records a CUDA event pair around the block into
    ``spans[name]``: the block's device time, read once the round has been
    waited for, at no synchronization of its own."""
    if dev.type != "cuda":
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    spans[name] = (start, end)


def span_ms(spans: dict) -> dict:
    """``{name_ms: device ms}`` of a round's spans, once the round has been
    waited for; a span that is a list of event pairs (the model-group
    collectives) gives their sum."""
    out = {}
    for name, val in sorted(spans.items()):
        pairs = val if isinstance(val, list) else [val]
        out[f"{name}_ms"] = sum(a.elapsed_time(b) for a, b in pairs)
    return out
