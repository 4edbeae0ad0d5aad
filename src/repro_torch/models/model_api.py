"""Model API over the architecture families + loss functions.

Every family module exposes:
    param_decls(cfg) -> ParamDecl tree
    forward(cfg, params, batch) -> (logits (B,S,V), aux_loss)
    prefill(cfg, params, batch) -> (last_logits (B,V), cache)
    decode_step(cfg, params, cache, batch) -> (logits (B,V), cache), the
        cache updated in place
    cache_decl(cfg, batch, cache_len) -> ParamDecl tree
The decoder takes the ``dense``, ``moe`` and ``vlm`` families; ``encdec``
is the encoder-decoder, ``rwkv`` RWKV6 and ``hybrid`` Hymba.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import sharding as shd
from repro_torch.models import decoder, encdec, hybrid, rwkv6

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


def init_params(cfg: ArchConfig, seed: int, device):
    return shd.materialize(param_decls(cfg), seed, device)


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


def loss_fn(cfg: ArchConfig, params, batch):
    logits, aux = get_model(cfg).forward(cfg, params, batch)
    ce = cross_entropy(logits, batch["labels"])
    return ce + aux, {"ce": ce, "aux": aux}
