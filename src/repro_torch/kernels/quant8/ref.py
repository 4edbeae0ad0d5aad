"""Plain PyTorch versions of the int8 block-quantization kernels
(``csrc/quant8.cu``): symmetric per-block quantization with one f32 scale
per ``block`` elements.  On the card they agree with the kernels bit for
bit; against the JAX package's oracles and Pallas kernels, too.

The reference writes ``amax / 127.0``; XLA compiles that division by a
constant as a multiply by the f32 reciprocal (``INV127``), and so does the
port; a true division gives some blocks a scale an ulp away from the
reference's.  ``x / scale`` stays a true division."""
from __future__ import annotations

import torch

INV127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))   # f32(1/127)


def quantize_ref(x: torch.Tensor, block: int = 256):
    """x: (N,) with N % block == 0 -> (q int8 (N,), scales f32 (N/block,)).
    ``scale = max(amax * f32(1/127), 1e-12)``, ``q = clip(round(x / scale))``
    with round half to even.  A NaN scale stays NaN, and a value that is
    NaN after the division is written as 0 (XLA's NaN -> int8)."""
    xb = x.to(torch.float32).reshape(-1, block)
    amax = xb.abs().amax(dim=1)
    scale = (amax * INV127).clamp(min=1e-12)
    r = torch.round(xb / scale[:, None]).clamp(-127, 127)
    q = torch.where(torch.isnan(r), 0.0, r).to(torch.int8)
    return q.reshape(-1), scale


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor, block: int = 256):
    qb = q.reshape(-1, block).to(torch.float32)
    return (qb * scale[:, None]).reshape(-1)
