"""Mixtral 8x22B — 56L, d=6144, 48H GQA kv=8, d_ff=16384, 8 experts top-2,
sliding-window attention.  [arXiv:2401.04088; hf]

8 experts do not divide the 16-way model axis, so the logical-axis resolver
falls through to intra-expert TP (d_ff sharded over ``model``).  SWA makes
long_500k decode well-defined (window-bounded KV).
"""
from repro_torch.configs.base import ArchConfig, FLConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    window=4096,
    moe=MoEConfig(
        n_experts=8,
        top_k=2,
        d_ff_expert=16384,
        capacity_factor=1.25,
    ),
    optimizer="adafactor",
    fl=FLConfig(mode="shared", schedule="tree", compress_pod_axis=True),
    notes="8 experts top-2, SWA [arXiv:2401.04088; hf]",
))
