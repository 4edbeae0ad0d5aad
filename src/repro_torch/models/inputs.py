"""Input construction for every (arch x shape) cell: abstract batches
(``batch_struct``, meta tensors that carry only shape and dtype) and
concrete random ones (``make_batch``, for smoke runs and examples).

Modality frontends are stubs, as in the reference: whisper gets
precomputed frame embeddings (``frames``), internvl2 precomputed patch
embeddings (``patches``) that fill the leading sequence positions.

The reference's ``batch_specs`` (the batch's PartitionSpecs) waits for the
multi-GPU slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import resolve


def _struct(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg: ArchConfig, shape: ShapeConfig, clients: int = 0):
    """Abstract batch: ``{name: meta tensor}``.  ``clients > 0`` prepends a
    client dim (training only)."""
    gb, S = shape.global_batch, shape.seq_len

    def shp(*dims):
        if clients:
            assert dims[0] % clients == 0, (dims, clients)
            return (clients, dims[0] // clients) + tuple(dims[1:])
        return tuple(dims)

    if shape.kind == "train":
        b = {"tokens": _struct(shp(gb, S), torch.int32),
             "labels": _struct(shp(gb, S), torch.int32)}
    elif shape.kind == "prefill":
        b = {"tokens": _struct((gb, S), torch.int32)}
    else:  # decode
        b = {"token": _struct((gb, 1), torch.int32),
             "pos": _struct((gb,), torch.int32)}
    if shape.kind in ("train", "prefill"):
        fe = cfg.frontend
        name = {"encdec": "frames", "vlm": "patches"}.get(cfg.family)
        if name:
            b[name] = _struct(shp(gb, fe.n_tokens, fe.feat_dim),
                              torch.bfloat16)
    return b


def make_batch(cfg: ArchConfig, shape: ShapeConfig, seed: int,
               clients: int = 0, device="cuda"):
    """Concrete random batch on ``device``, drawn leaf by leaf (in
    ``batch_struct``'s order) from one ``torch.Generator`` seeded with
    ``seed``: token ids uniform in the vocab, ``pos`` the last position,
    frontend embeddings standard normal rounded to bf16.  The draws differ
    from the reference's ``jax.random``; the distributions are the same."""
    dev = resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for name, st in batch_struct(cfg, shape, clients).items():
        if name in ("tokens", "labels", "token"):
            out[name] = torch.randint(0, cfg.vocab, st.shape, generator=gen,
                                      dtype=torch.int32, device=dev)
        elif name == "pos":
            out[name] = torch.full(st.shape, shape.seq_len - 1,
                                   dtype=torch.int32, device=dev)
        else:
            out[name] = torch.randn(st.shape, generator=gen,
                                    dtype=torch.float32,
                                    device=dev).to(st.dtype)
    return out
