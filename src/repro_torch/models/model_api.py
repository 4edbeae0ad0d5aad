"""Model API over the architecture families + loss functions.

Every family module exposes:
    param_decls(cfg) -> ParamDecl tree
    forward(cfg, params, batch) -> (logits (B,S,V), aux_loss)
    prefill(cfg, params, batch) -> (last_logits (B,V), cache)
    decode_step(cfg, params, cache, batch) -> (logits (B,V), cache), the
        cache updated in place
    (every family also takes ``tp``, ``dp`` and the cache's ``layout``
    there, to serve on ranks; the encoder-decoder also its cross cache's
    ``cross_layout``)
    cache_decl(cfg, batch, cache_len) -> ParamDecl tree
The decoder takes the ``dense``, ``moe`` and ``vlm`` families; ``encdec``
is the encoder-decoder, ``rwkv`` RWKV6 and ``hybrid`` Hymba.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.models import decoder, encdec, hybrid, rwkv6
from repro_torch.models.layers import logits_out
from repro_torch.obs import spans

_FAMILY = {
    "dense": decoder,
    "moe": decoder,
    "vlm": decoder,
    "encdec": encdec,
    "rwkv": rwkv6,
    "hybrid": hybrid,
}


def get_model(cfg: ArchConfig):
    return _FAMILY[cfg.family]


def param_decls(cfg: ArchConfig):
    return get_model(cfg).param_decls(cfg)


def serve_specs(cfg: ArchConfig, mesh):
    """The parameters' specs for serving on ``mesh``: the reference's
    serving layout (``launch/dryrun.py``), ``specs_for`` of the decls under
    ``rules_for(cfg.fl.mode)`` (in ``shared`` mode ``embed`` on ``data``)."""
    return shd.specs_for(param_decls(cfg), shd.rules_for(cfg.fl.mode), mesh)


def init_params(cfg: ArchConfig, seed: int, device, mesh=None):
    """The parameters from ``seed``; with ``mesh``, only the rank's blocks
    under ``serve_specs`` (each drawn as the whole tree's, a stacked leaf a
    layer at a time: on a (1, 1) mesh the whole tree, bit for bit), on
    ``device``."""
    if mesh is None:
        return shd.materialize(param_decls(cfg), seed, device)
    specs = T.leaves(serve_specs(cfg, mesh))
    return shd.materialize(
        param_decls(cfg), seed, device,
        lambda i, x: shd.local_block(x, specs[i], mesh))


def cache_len_for(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.family == "rwkv":
        return 0  # recurrent state only
    return min(cfg.window, seq_len) if cfg.window else seq_len


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy, computed in f32 with a stop-gradient max."""
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    label_logit = lf.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - label_logit).mean()


def loss_fn(cfg: ArchConfig, params, batch, tp=None, dp=None):
    """-> (loss, {"ce", "aux"}).  With ``tp``
    (``dist.tensor_parallel.ModelAxis``) ``params`` are this rank's blocks
    of a client split over the ``model`` axis, the logits its vocab rows,
    and the cross-entropy the vocab-parallel one; every rank of the client
    gets the same loss.  An MoE layer's auxiliary loss comes from the
    router gathered whole, so it is whole on every rank and added once
    there, as on one device (never summed over the model group).

    With ``dp`` (``dist.fsdp.DataAxis``, the ``shared`` mode) ``params``
    are also split on ``data`` and ``batch`` is this rank's rows of its
    client's (or, where the batch does not split, the whole of it): the
    loss is this rank's, the cross-entropy over its rows plus the
    auxiliary loss of the client's whole batch, which is equal on every
    data rank.  The client's loss is the mean of its data ranks' losses
    (the round step averages them), so the auxiliary term counts once in
    it, and the gradients are that mean's (``dist.fsdp``).

    Every family takes ``tp`` and ``dp``.  Where the model axis leaves the
    padded vocab whole (``tensor_parallel.along``) the logits are whole on
    every rank and the cross-entropy is the plain one.

    The decoder families' head, the logits and the cross-entropy, runs as
    the block ``fl/head`` (``obs.spans``)."""
    model = get_model(cfg)
    if model is decoder:
        x, aux = decoder.trunk(cfg, params, batch, tp, dp)
        ce = spans.block("fl/head", _head, x, params["embed"],
                         batch["labels"], tp, dp)
    else:
        logits, aux = model.forward(cfg, params, batch, tp, dp)
        ce = _cross_entropy(logits, batch["labels"], tp)
    return ce + aux, {"ce": ce, "aux": aux}


def _cross_entropy(logits, labels, tp):
    vp = tpar.along(tp, "vocab")
    return cross_entropy(logits, labels) if vp is None else \
        tpar.cross_entropy(logits, labels, vp)


def _head(x, embed, labels, tp=None, dp=None):
    """The decoder's head: the final norm's output ``x`` through the
    logits to the cross-entropy."""
    return _cross_entropy(logits_out(embed, x, tp, dp), labels, tp)
