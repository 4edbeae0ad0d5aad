"""Whisper-small — enc-dec, 12L encoder + 12L decoder, d=768, 12H MHA,
d_ff=3072, vocab 51865.  Conv audio frontend is a STUB: input_specs feeds
precomputed frame embeddings (1500 x 768).  [arXiv:2212.04356]
"""
from repro_torch.configs.base import ArchConfig, FLConfig, FrontendConfig, register

CONFIG = register(ArchConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    n_enc_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    frontend=FrontendConfig(kind="audio", n_tokens=1500, feat_dim=768),
    fl=FLConfig(mode="replica", schedule="tree"),
    notes="enc-dec, conv frontend stub [arXiv:2212.04356; unverified]",
))
