"""MoE parallelism variants selected by ``cfg.moe.impl``.

In the reference both share the capacity-dispatch math of
``models/moe.moe_apply_dense`` and differ only in the sharding constraints
pinned on the dispatch buffers, which apply only when a mesh with a
``model`` axis is active and the dim divides it:

  * ``ep_a2a``   — expert parallelism: the (E, cap, D) dispatch buffer
                   sharded over ``model`` on the experts dim;
  * ``tp_local`` — intra-expert tensor parallelism: the (E, cap, F) expert
                   activations sharded over ``model`` on the d_ff dim.

The constraint only steers GSPMD; the parameters' specs fix where the
expert weights live.  Here the split is written out, and the expert
leaves' specs decide its form (``tensor_parallel.moe_split``: the experts
claim the model axis where they divide it, their FFN width otherwise).  So
both variants take the client's model axis ``tp`` and run
``moe_apply_dense`` in that form: expert parallelism or intra-expert
tensor parallelism over the model ranks, or the whole layer on one device
without ``tp``; a ``dp`` (the ``shared`` mode's data axis) routes the
client's whole batch.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.moe import moe_apply_dense


def moe_apply_a2a(cfg: ArchConfig, p, x, tp=None, dp=None):
    return moe_apply_dense(cfg, p, x, tp, dp)


def moe_apply_tp_local(cfg: ArchConfig, p, x, tp=None, dp=None):
    return moe_apply_dense(cfg, p, x, tp, dp)
