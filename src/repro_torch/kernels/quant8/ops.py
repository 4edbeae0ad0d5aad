"""Dispatch for the quant8 kernels (``csrc/quant8.cu``): padding and the
flat API of the JAX package's ``kernels/quant8/ops.py``.

A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises; a meta tensor (a dry run) gets the outputs' shapes
and dtypes and launches nothing.  ``quantize_launches`` and
``dequantize_launches`` count kernel launches; ``quantize_cost`` and
``dequantize_cost`` give one launch's (FLOPs, bytes), which each launch
and each meta call reports to the active op counters (``_build.record``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.quant8.ref import dequantize_ref, quantize_ref

QBLOCK = 256          # elements per scale
ROWS = 256            # the reference's rows per tile: pads to QBLOCK*ROWS

quantize_launches = 0
dequantize_launches = 0

_QFN = {torch.bfloat16: "quant8_quantize_bf16",
        torch.float32: "quant8_quantize_f32"}


def quantize_cost(n: int, dtype) -> tuple[float, float]:
    """(FLOPs, bytes) of quantizing ``n`` values of ``dtype``: an absmax
    compare and a scaled round a value; the input read, the int8 values
    and one f32 scale a block written."""
    return 2.0 * n, n * dtype.itemsize + n + 4 * n / QBLOCK


def dequantize_cost(n: int) -> tuple[float, float]:
    """(FLOPs, bytes) of dequantizing ``n`` values: a multiply a value; the
    int8 values and the scales read, the f32 values written."""
    return float(n), n + 4 * n / QBLOCK + 4 * n


def _to_rows(x_flat: torch.Tensor) -> torch.Tensor:
    """Zero-pad a flat tensor to a multiple of QBLOCK*ROWS -> (R, QBLOCK)."""
    pad = (-x_flat.shape[0]) % (QBLOCK * ROWS)
    if pad:
        x_flat = F.pad(x_flat, (0, pad))
    return x_flat.reshape(-1, QBLOCK)


def quantize(x: torch.Tensor):
    """x: any shape -> (q int8 (R, QBLOCK), scales f32 (R,), n = x.numel()).
    The padding rows quantize to q = 0 with scale 1e-12."""
    global quantize_launches
    n = x.numel()
    rows = _to_rows(x.reshape(-1))
    if x.device.type == "cpu":
        q, s = quantize_ref(rows.reshape(-1), QBLOCK)
        return q.reshape(-1, QBLOCK), s, n
    meta = x.device.type == "meta"
    if not meta:
        _build.check_device(x, "quantize")
    if x.dtype not in _QFN:
        raise TypeError(f"quantize kernel takes bf16 or f32, got {x.dtype}")
    rows = rows.contiguous()
    R = rows.shape[0]
    q = torch.empty((R, QBLOCK), dtype=torch.int8, device=x.device)
    s = torch.empty((R,), dtype=torch.float32, device=x.device)
    if not meta:
        status = getattr(_build.load(), _QFN[x.dtype])(
            rows.data_ptr(), q.data_ptr(), s.data_ptr(), R,
            _build.stream_ptr(x))
        _build.check_status(status, "quantize")
        quantize_launches += 1
    _build.record("quantize", quantize_cost, n, x.dtype)
    return q, s, n


def dequantize(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """(R, QBLOCK) int8 and (R,) f32 scales -> the first n values, f32."""
    global dequantize_launches
    if q.dim() != 2 or q.shape[1] != QBLOCK or scale.shape != q.shape[:1]:
        raise ValueError(f"dequantize takes q (R, {QBLOCK}) and scales (R,), "
                         f"got {tuple(q.shape)} and {tuple(scale.shape)}")
    if q.device.type == "cpu":
        return dequantize_ref(q.reshape(-1), scale, QBLOCK)[:n]
    meta = q.device.type == "meta"
    if not meta:
        _build.check_device(q, "dequantize")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"dequantize kernel takes int8 q and f32 scales, got "
                        f"{q.dtype} and {scale.dtype}")
    if not (q.is_contiguous() and scale.is_contiguous()) \
            or scale.device != q.device:
        raise ValueError("dequantize kernel takes contiguous q and scales "
                         "on one card")
    R = q.shape[0]
    out = torch.empty((R, QBLOCK), dtype=torch.float32, device=q.device)
    if not meta:
        status = _build.load().quant8_dequantize(
            q.data_ptr(), scale.data_ptr(), out.data_ptr(), R,
            _build.stream_ptr(q))
        _build.check_status(status, "dequantize")
        dequantize_launches += 1
    _build.record("dequantize", dequantize_cost, n)
    return out.reshape(-1)[:n]
