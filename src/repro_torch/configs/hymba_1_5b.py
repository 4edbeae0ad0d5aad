"""Hymba-1.5B — hybrid parallel attention + SSM heads: 32L, d=1600,
25H GQA kv=5, d_ff=5504, ssm_state=16, sliding window.
SSM branch uses SSD form (scalar per-head decay) — TPU adaptation noted in
DESIGN.md.  [arXiv:2411.13676; hf]"""
from repro_torch.configs.base import ArchConfig, FLConfig, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    head_dim=64,
    window=1024,
    ssm_state=16,
    fl=FLConfig(mode="replica", schedule="tree"),
    notes="parallel attn+mamba heads [arXiv:2411.13676; hf]",
))
