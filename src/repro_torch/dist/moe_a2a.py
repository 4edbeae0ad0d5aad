"""MoE parallelism variants selected by ``cfg.moe.impl``.

In the reference both share the capacity-dispatch math of
``models/moe.moe_apply_dense`` and differ only in the sharding constraints
pinned on the dispatch buffers, which apply only when a mesh with a
``model`` axis is active and the dim divides it:

  * ``ep_a2a``   — expert parallelism: the (E, cap, D) dispatch buffer
                   sharded over ``model`` on the experts dim;
  * ``tp_local`` — intra-expert tensor parallelism: the (E, cap, F) expert
                   activations sharded over ``model`` on the d_ff dim.

The port runs on one device, where the reference also runs the math
unconstrained, so each variant is ``moe_apply_dense``.  The constraints
come with the multi-GPU slice.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.moe import moe_apply_dense


def moe_apply_a2a(cfg: ArchConfig, p, x):
    return moe_apply_dense(cfg, p, x)


def moe_apply_tp_local(cfg: ArchConfig, p, x):
    return moe_apply_dense(cfg, p, x)
