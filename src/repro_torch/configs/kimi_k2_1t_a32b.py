"""Kimi K2 — trillion-param MoE (61L, d=7168, 64H GQA kv=8, 384 experts
top-8, 1 shared expert, first layer dense).  [arXiv:2501.kimi2]

Deployment notes: FL mode is ``shared`` (one client per pod; 1T params are
FSDP-sharded over data x model within the pod).  Adafactor — Adam moments
for 1T params cannot fit a 256-chip v5e pod (documented in EXPERIMENTS.md).
Experts shard over ``model`` (384/16 = 24 per chip: expert parallelism).
"""
from repro_torch.configs.base import ArchConfig, FLConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    moe=MoEConfig(
        n_experts=384,
        top_k=8,
        d_ff_expert=2048,
        n_shared_experts=1,
        first_k_dense=1,
        d_ff_dense=18432,   # (top_k + shared) x 2048 — matches K2's dense ff
        capacity_factor=1.25,
    ),
    optimizer="adafactor",
    fl=FLConfig(mode="shared", schedule="tree", compress_pod_axis=True),
    notes="paper-table config [arXiv:2501.kimi2; unverified]",
))
