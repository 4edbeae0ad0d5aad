"""KV caches (full-length and sliding-window ring buffers) for serving.
Cache layout: stacked over layers, ``(L, B, S, K, hd)``, with one
``kv_pos`` (B, S) of the absolute position held in each slot (-1: empty).

The reference's decode scan returns a new cache each step; here decode
writes the token's keys, values and position into the cache's tensors in
place (one advanced-index assignment a layer), so a step copies nothing
of the cache.

On a mesh a rank holds its block of each leaf under the reference's
serving rules (``cache_specs``: ``batch`` on ``data``, ``cache_seq`` on
``model``, and, where ``cache_seq`` does not take it, ``kv_heads``), which
gives a full-attention cache one of three layouts (``CacheLayout``; the
encoder-decoder's self and cross caches one each, ``layout_for``):

* ``seq``: the cache length C divides the model axis M; rank m holds slots
  ``[m C/M, (m+1) C/M)`` of every kv head.  Decode writes a token only on
  the rank that owns its slot ``pos % C`` (``token_slot``), and attention
  merges the ranks' partial softmaxes (``attention.split_decode_attention``);
* ``heads``: C does not divide M but the kv heads do; a rank holds its kv
  heads at every slot, the tensor-parallel layout;
* ``whole``: neither divides; every rank holds the whole cache (on one
  device, the only layout).

A seq-split cache cannot grow (appending moves every block boundary), so
prefill allocates the final length (``serve_cache_len``, the layout's
``length``) and decode writes into it; one device takes the same path
with the layout ``whole``.  The recurrent states follow
their heads: RWKV6's ``S`` and Hymba's ``ssm_S`` split where the heads
split.  Hymba's ``conv`` state (B, CONV_W - 1, Din) declares its ``Din``
dim on ``heads``, which the reference's resolver splits wherever Din
divides M, also where the heads stay whole (hymba-1.5b's 25 heads of 64 at
M = 2 or 4); here it follows the heads, whole where they are whole (a
rank's SSM branch then runs every head), which ``cache_specs`` records.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree as T
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.dist.sharding import decl


def kv_cache_decl(n_layers: int, batch: int, cache_len: int, n_kv: int,
                  head_dim: int, dtype=torch.bfloat16, prefix: str = ""):
    return {
        prefix + "k": decl((n_layers, batch, cache_len, n_kv, head_dim),
                           ("layers", "batch", "cache_seq", "kv_heads", None),
                           init="zeros", dtype=dtype),
        prefix + "v": decl((n_layers, batch, cache_len, n_kv, head_dim),
                           ("layers", "batch", "cache_seq", "kv_heads", None),
                           init="zeros", dtype=dtype),
        prefix + "kv_pos": decl((batch, cache_len), ("batch", "cache_seq"),
                                init="neg_ones", dtype=torch.int32),
    }


def cache_slot(pos: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Ring-buffer slot for absolute position ``pos`` (B,)."""
    return pos % cache_len


def prefilled_pos(batch: int, seq: int, device, start: int = 0):
    """kv_pos of a prefilled cache holding positions start..start+seq-1."""
    pos = torch.arange(start, start + seq, dtype=torch.int32, device=device)
    return pos.expand(batch, seq).contiguous()


# --------------------------------------------------------------------------
# A cache split over a mesh
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CacheLayout:
    """How a rank holds a full-attention cache of ``length`` slots: kind
    ``seq``, ``heads`` or ``whole`` (module docstring) on a model axis of
    ``size`` where it is rank ``rank``."""
    kind: str
    length: int
    size: int = 1
    rank: int = 0

    @property
    def local(self) -> int:
        """The slots this rank holds."""
        return self.length // self.size if self.kind == "seq" else self.length

    @property
    def start(self) -> int:
        """The first of them."""
        return self.rank * self.local if self.kind == "seq" else 0

    def kv_heads(self, n_kv: int) -> int:
        """The kv heads this rank holds of ``n_kv``."""
        return n_kv // self.size if self.kind == "heads" else n_kv


def serve_cache_len(cfg, S: int, max_new: int, max_seq: int) -> int:
    """The slots a served batch's cache gets at prefill, as the engine
    sizes it: a full-attention cache the prompt's S and the new tokens
    (``min(S + max_new + 1, max_seq)``, never under S); a windowed
    decoder's keeps its prefilled S and wraps (ROADMAP R4); Hymba's its
    window ring ``min(window, S)``; RWKV6 none (its state)."""
    if cfg.family == "rwkv":
        return 0
    if cfg.family == "hybrid":
        return min(cfg.window or S, S)
    if cfg.window is not None:
        return S
    return max(S, min(S + max_new + 1, max_seq))


def cache_specs(cfg, decls, mesh):
    """The specs of cache ``decls`` (a family's ``cache_decl``) on
    ``mesh``: the reference's ``specs_for`` under ``rules_for(cfg.fl.mode)``,
    but a dim on ``heads`` stays whole where the heads do
    (``tensor_parallel.split_blocks``' ``heads``; Hymba's ``conv`` Din
    dim, see the module docstring)."""
    specs = shd.specs_for(decls, shd.rules_for(cfg.fl.mode), mesh)
    size = shd.mesh_shape(mesh).get("model", 1)
    split = tpar.split_blocks(cfg, size)["heads"]

    def follow(d, spec):
        return tuple(None if a == "heads" and not split else m
                     for a, m in zip(d.axes, spec))
    return T.tree_map(follow, decls, specs)


def layout_for(cfg, decls, mesh=None, prefix: str = ""):
    """The layout of cache ``decls``' keys ``prefix + "k"`` on ``mesh``
    (``whole`` on one device), or None for a cache without them (RWKV6's
    state; ``prefix="cross_"`` outside the encoder-decoder).  Each pair of
    keys takes its own spec: the encoder-decoder's cross cache of
    n_frames slots can split on its sequence where its self cache of
    another length splits on its kv heads."""
    key = prefix + "k"
    if key not in decls:
        return None
    length = decls[key].shape[2]
    if mesh is None or shd.mesh_shape(mesh).get("model", 1) == 1:
        return CacheLayout("whole", length)
    spec = cache_specs(cfg, decls, mesh)[key]
    kind = ("seq" if spec[2] == "model" else
            "heads" if spec[3] == "model" else "whole")
    sizes = shd.mesh_shape(mesh)
    return CacheLayout(kind, length, sizes["model"],
                       shd.mesh_coords(sizes, mesh.rank)["model"])


def cache_heads(t: torch.Tensor, tp, lay: CacheLayout) -> torch.Tensor:
    """Keys or values (B, n, k, hd) as a layer projects them (its rank's
    kv heads, or with the kv heads whole while the q heads split, those its
    q heads read: one, or one a q head where they straddle kv groups) ->
    the kv heads the rank's cache holds: its own under ``heads``, every one
    under ``seq`` and ``whole`` (gathered over the model axis, each kv head
    from the first q head that reads it, ``kv_gather_index``).  Where the
    heads stay whole ``t`` is whole already."""
    hp = tpar.along(tp, "heads")
    if hp is None or lay.kind == "heads":
        return t
    every = tpar.gather_from_model(t, hp, 2)
    if hp.blocks["kv_heads"]:
        return every
    return every[:, :, tpar.kv_gather_index(hp)]


def prefill_kv(dst: torch.Tensor, src: torch.Tensor, lay: CacheLayout):
    """Writes ``src`` (B, n, k, hd), slots 0..n-1 of the whole cache, into
    ``dst`` (B, lay.local, k, hd), the rank's slots (in place)."""
    n = min(src.shape[1] - lay.start, lay.local)
    if n > 0:
        dst[:, :n].copy_(src[:, lay.start:lay.start + n])


def prefilled_layout_pos(batch: int, seq: int, lay: CacheLayout, device,
                         start: int = 0) -> torch.Tensor:
    """kv_pos of the rank's slots of a cache whose slots 0..seq-1 hold
    positions start..start+seq-1 (the rest empty, -1)."""
    pos = torch.full((batch, lay.length), -1, dtype=torch.int32,
                     device=device)
    pos[:, :seq] = prefilled_pos(batch, seq, device, start)
    return pos[:, lay.start:lay.start + lay.local].contiguous()


def token_slot(pos: torch.Tensor, lay: CacheLayout):
    """-> (the rows, the slot of position ``pos`` (B,) in the rank's
    block, whether the rank owns it (B,), or None where every rank holds
    every slot): a decode step's index, made once for all its layers."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    slot = cache_slot(pos, lay.length).long()
    if lay.kind != "seq":
        return rows, slot, None
    local = slot - lay.start
    own = (local >= 0) & (local < lay.local)
    return rows, local.clamp(0, lay.local - 1), own


def write_token(t: torch.Tensor, slots, value: torch.Tensor):
    """``t[b, slot_b] = value[b]`` in place (t: (B, C, ...), value: (B,
    ...)), only in the rows the rank owns (``token_slot``)."""
    rows, idx, own = slots
    value = value.to(t.dtype)
    if own is not None:
        keep = own.view((-1,) + (1,) * (value.dim() - 1))
        value = torch.where(keep, value, t[rows, idx])
    t[rows, idx] = value
