"""InternLM2-20B — dense, 48L, d=6144, 48H GQA kv=8, d_ff=16384,
vocab 92544.  [arXiv:2403.17297; hf]"""
from repro_torch.configs.base import ArchConfig, FLConfig, register

CONFIG = register(ArchConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92544,
    optimizer="adafactor",   # replica-mode Adam moments for 20B x 16 clients
                             # would exceed v5e HBM; see EXPERIMENTS.md
    fl=FLConfig(mode="replica", schedule="tree"),
    notes="GQA [arXiv:2403.17297; hf]",
))
