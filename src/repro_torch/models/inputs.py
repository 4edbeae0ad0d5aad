"""Input construction for every (arch x shape) cell: abstract batches
(``batch_struct``, meta tensors that carry only shape and dtype) and
concrete random ones (``make_batch``, for smoke runs and examples).

Modality frontends are stubs, as in the reference: whisper gets
precomputed frame embeddings (``frames``), internvl2 precomputed patch
embeddings (``patches``) that fill the leading sequence positions.

``batch_specs`` is the reference's: the batch's specs as tuples of mesh-axis
names, equal to its PartitionSpecs.  On the port's mesh only the clients
dim is split: each of a client's M ranks on the ``model`` axis gets the
whole client batch (the trainer's ``FederatedTokens.client_batch``).  The
reference's spec puts the sequence on ``model`` and GSPMD reshards it
where the layers need it; feeding every rank the whole sequence computes
the same function, with the model's split in the layers
(``dist/tensor_parallel.py``).  Sequence parallelism over ``model`` is not
ported.  In ``shared`` mode a client's batch also splits over its
``data`` ranks where it divides them (``rank_rows``, the spec's ``ok``
rule), as the reference's spec puts the per-client batch dim on ``data``.
"""
from __future__ import annotations

from typing import Optional

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


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, clients: int = 0,
                client_axis: Optional[str] = None, data_axis: str = "data",
                seq_axis: Optional[str] = "model",
                axis_sizes: Optional[dict] = None):
    """Specs matching ``batch_struct``.  The sequence dim shards over the
    ``model`` axis (sequence parallelism).  Dims that don't divide their
    mesh axis stay whole (e.g. global_batch=1 for long_500k)."""
    sizes = axis_sizes or {"data": 16, "model": 16, "pod": 2}

    def ok(dim, ax):
        return ax is not None and dim % sizes.get(ax, 1) == 0

    def sp(shp, has_seq):
        parts = []
        if clients:
            parts.append(client_axis if ok(shp[0], client_axis) else None)
            ax = data_axis if client_axis != data_axis else None
            parts.append(ax if len(shp) > 1 and ok(shp[1], ax) else None)
        else:
            parts.append(data_axis if ok(shp[0], data_axis) else None)
        if has_seq and len(shp) > len(parts):
            parts.append(seq_axis if ok(shp[len(parts)], seq_axis) else None)
        parts += [None] * (len(shp) - len(parts))
        return tuple(parts[:len(shp)])

    return {k: sp(v.shape, k in ("tokens", "labels")
                  and shape.kind != "decode")
            for k, v in batch_struct(cfg, shape, clients).items()}


def rank_rows(batch: dict, size: int, rank: int):
    """-> (this data rank's rows of a client's ``batch``, whether the batch
    is split).  Where the batch size B divides the ``size`` data ranks,
    rank d takes rows ``d*B/size .. (d+1)*B/size`` of every leaf;
    otherwise every rank takes the whole batch (``batch_specs``' rule,
    which leaves a dim whole where it does not divide its axis)."""
    B = next(iter(batch.values())).shape[0]
    if size == 1 or B % size:
        return batch, False
    n = B // size
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}, True


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
