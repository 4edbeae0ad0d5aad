"""InternVL2-2B — InternViT + InternLM2 backbone: 24L, d=2048, 16H GQA kv=8,
d_ff=8192, vocab 92553.  The ViT frontend is a STUB: input_specs feeds 256
precomputed patch embeddings that fill the leading sequence positions.
[arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ArchConfig, FLConfig, FrontendConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    frontend=FrontendConfig(kind="vision", n_tokens=256, feat_dim=2048),
    fl=FLConfig(mode="replica", schedule="tree"),
    notes="InternViT + InternLM2 [arXiv:2404.16821; hf]",
))
