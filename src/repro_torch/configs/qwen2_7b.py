"""Qwen2-7B — dense, 28L, d=3584, 28H GQA kv=4, d_ff=18944, vocab 152064,
QKV bias.  [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ArchConfig, FLConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    qkv_bias=True,
    fl=FLConfig(mode="replica", schedule="tree"),
    notes="GQA, QKV bias [arXiv:2407.10671; hf]",
))
