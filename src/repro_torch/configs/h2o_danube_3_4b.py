"""H2O-Danube-3-4B — dense llama+mistral mix, 24L, d=3840, 32H GQA kv=8,
d_ff=10240, vocab 32000, sliding-window attention.  [arXiv:2401.16818]"""
from repro_torch.configs.base import ArchConfig, FLConfig, register

CONFIG = register(ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    window=4096,
    fl=FLConfig(mode="replica", schedule="tree"),
    notes="llama+mistral mix, SWA [arXiv:2401.16818; unverified]",
))
