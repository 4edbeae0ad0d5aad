"""Collective/wire compression: int8 block quantization with per-row
(last-dim) absmax scales, plus the error-feedback variant that keeps the
quantization residual bounded across rounds.  Used by the single-device
``compressed`` aggregation schedule (core/aggregation.py) on tensors AND by
the host MQTT codecs (core/client.py ``uplink_codec="int8_ef"``,
``"topk_int8_ef"``, ``downlink_codec="int8"``) with ``xp=numpy``, so both
data paths share one quantizer.

``xp`` is the array namespace: ``numpy`` or ``torch``.  With ``xp=None``
it follows the input: a ``torch.Tensor`` stays a tensor, anything else
comes back as numpy.  Each function has one body, written in torch:
numpy inputs are viewed as CPU tensors on entry and the results turned
back into numpy arrays on return.  The arithmetic matches numpy's bit for
bit (division by the scale, never a multiply by its reciprocal; rounding
half to even).  One step keeps numpy: ``topk_sparsify`` picks a numpy
input's indices with ``argpartition``, as the reference's numpy leg does,
so ties between equal magnitudes (the zeros of a sparse delta) resolve as
they do there."""
from __future__ import annotations

import numpy as np
import torch


def _as_numpy(x, xp) -> bool:
    if xp is None:
        return not torch.is_tensor(x)
    if xp is torch:
        return False
    if xp is np:
        return True
    raise TypeError(f"xp must be numpy, torch or None, got {xp!r}")


def _t(x, like=None) -> torch.Tensor:
    """``x`` as a tensor (on ``like``'s device when given); a numpy array
    is shared, or copied first when it is read-only."""
    if not torch.is_tensor(x):
        a = np.asarray(x)
        x = torch.from_numpy(a if a.flags.writeable else a.copy())
    return x if like is None else x.to(like.device)


def _out(ts, as_numpy: bool):
    if not as_numpy:
        return ts
    return tuple(t.numpy() for t in ts) if isinstance(ts, tuple) \
        else ts.numpy()


def _div127(a: torch.Tensor) -> torch.Tensor:
    """``a / 127`` as an IEEE division on every device: PyTorch's CUDA
    kernel multiplies by the reciprocal when the divisor is a Python
    scalar, which moves some scales by an ulp."""
    return a / torch.full_like(a, 127.0)


def quantize_int8(x, xp=None):
    """x -> (q int8, scale f32).  Scales are per last-dim row (keepdims), so
    ``q * scale`` broadcasts back to x's shape.  Max error <= absmax/127."""
    as_np = _as_numpy(x, xp)
    xf = _t(x).to(torch.float32)
    if xf.dim() == 0:
        xf = xf.reshape(1)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = _div127(torch.where(amax > 0, amax, 1.0))
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return _out((q, scale), as_np)


def dequantize_int8(q, scale, xp=None):
    as_np = _as_numpy(q, xp)
    qt = _t(q)
    return _out(qt.to(torch.float32) * _t(scale, qt), as_np)


def quantize_with_error_feedback(x, err, xp=None):
    """Quantize ``x + err`` and carry the new residual forward.  The
    residual never exceeds one quantization step (absmax/127), so repeated
    compressed rounds do not drift."""
    as_np = _as_numpy(x, xp)
    xt = _t(x)
    t = xt.to(torch.float32) + _t(err, xt)
    q, scale = quantize_int8(t)
    new_err = t - dequantize_int8(q, scale)
    return _out((q, scale, new_err), as_np)


def topk_count(size: int, density: float) -> int:
    """Number of coordinates a top-k codec keeps for a flat tensor of
    ``size`` elements at the given density (always at least one)."""
    if size <= 0:
        return 0
    k = int(-(-size * float(density) // 1))  # ceil without math import
    return max(1, min(size, k))


def topk_sparsify(x, density, xp=None):
    """Magnitude top-k over the *flattened* tensor.

    Returns ``(idx int32, vals f32)`` with indices sorted ascending so the
    encoding is deterministic and scatter order never matters.  numpy
    inputs use O(n) ``argpartition``; tensors use ``torch.topk``.
    Tie-breaking between the two can differ on exactly-equal magnitudes —
    callers that need bit-parity across backends feed tie-free inputs.
    """
    as_np = _as_numpy(x, xp)
    flat = _t(x).to(torch.float32).reshape(-1)
    n = int(flat.shape[0])
    k = topk_count(n, density)
    if k == 0:
        idx = torch.zeros((0,), dtype=torch.int64, device=flat.device)
    elif k >= n:
        idx = torch.arange(n, dtype=torch.int64, device=flat.device)
    elif as_np:
        mag = flat.abs().numpy()
        idx = torch.from_numpy(np.sort(np.argpartition(mag, n - k)[n - k:]))
    else:
        idx = torch.sort(torch.topk(flat.abs(), k).indices).values
    return _out((idx.to(torch.int32), flat[idx]), as_np)


def quantize_topk_int8_ef(x, err, density, xp=None):
    """Top-k + int8 + error feedback: the uplink codec for large models.

    Sparsifies ``x + err`` to the top ``density`` fraction of coordinates by
    magnitude, int8-quantizes the survivors with ONE absmax scale for the
    whole tensor, and carries *everything not sent* — the un-selected mass
    plus the quantization residual of the selected values — in the returned
    error-feedback residual.  Mass conservation holds by construction:

        densify(idx, q, scale, shape) + new_err == x + err   (in f32)

    Returns ``(idx int32, q int8, scale f32[1], new_err)`` with ``new_err``
    shaped like ``x``.
    """
    as_np = _as_numpy(x, xp)
    xt = _t(x)
    t = xt.to(torch.float32) + _t(err, xt)
    idx, vals = topk_sparsify(t.numpy() if as_np else t, density)
    idx, vals = _t(idx), _t(vals)
    amax = vals.abs().max() if vals.numel() else \
        torch.zeros((), device=t.device)
    scale = _div127(torch.where(amax > 0, amax, 1.0)).reshape(1)
    q = torch.round(vals / scale).clamp(-127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    new_err = t.reshape(-1).clone()
    new_err[idx.long()] -= deq
    return _out((idx, q, scale, new_err.reshape(t.shape)), as_np)


def densify_topk(idx, q, scale, shape, xp=None):
    """Scatter a top-k int8 payload back to a dense f32 tensor."""
    n = 1
    for d in shape:
        n *= int(d)
    as_np = _as_numpy(q, xp)
    qt = _t(q)
    deq = qt.to(torch.float32) * _t(scale, qt).reshape(-1)[0]
    out = torch.zeros(n, dtype=torch.float32, device=qt.device)
    out[_t(idx, qt).long()] = deq
    return _out(out.reshape(tuple(shape)), as_np)
