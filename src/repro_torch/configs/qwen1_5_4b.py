"""Qwen1.5-4B — dense, 40L, d=2560, 20H MHA (kv=20), d_ff=6912,
vocab 151936, QKV bias.  [hf:Qwen/Qwen1.5-0.5B family]"""
from repro_torch.configs.base import ArchConfig, FLConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab=151936,
    qkv_bias=True,
    fl=FLConfig(mode="replica", schedule="tree"),
    notes="QKV bias [hf:Qwen/Qwen1.5; hf]",
))
