"""RWKV6-7B ("Finch") — attention-free, 32L, d=4096, d_ff=14336,
vocab 65536, data-dependent decay.  64 heads of dim 64.
[arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ArchConfig, FLConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-7b",
    family="rwkv",
    n_layers=32,
    d_model=4096,
    n_heads=64,          # d_model / rwkv_head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    rwkv_head_dim=64,
    rwkv_chunk=128,
    fl=FLConfig(mode="replica", schedule="tree"),
    notes="Finch — data-dependent decay [arXiv:2404.05892; hf]",
))
