"""Config system: architecture + shape + FL deployment configuration.

Every assigned architecture is a frozen ``ArchConfig`` registered under its
public id (``--arch <id>``).  Shapes are the four assigned input-shape
presets.  ``FLConfig`` carries the SDFLMQ deployment knobs (client mapping,
cluster topology policy, aggregation schedule).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

# --------------------------------------------------------------------------
# Architecture configuration
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    first_k_dense: int = 0           # leading dense (non-MoE) layers
    d_ff_dense: int = 0              # d_ff of those dense layers
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_coef: float = 0.01           # load-balancing auxiliary loss weight
    impl: str = "auto"               # "auto" (pjit einsum) | "ep_a2a" (shard_map)


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend stub: input_specs() provides precomputed embeddings."""
    kind: str                        # "audio" | "vision"
    n_tokens: int                    # frames / patches
    feat_dim: int                    # embedding dim delivered by the stub


@dataclass(frozen=True)
class FLConfig:
    """SDFLMQ deployment configuration (paper §III)."""
    mode: str = "replica"            # "replica": client per data-row;
                                     # "shared": FSDP params, client per pod
    local_steps: int = 1             # local epochs per FL round (E)
    aggregator_ratio: float = 0.3    # paper Fig.8: 30% of clients aggregate
    levels: int = 3                  # hierarchy depth incl. root (paper: 3)
    schedule: str = "tree"           # "tree" (paper) | "flat" (centralized
                                     # baseline) | "rs_ag" (beyond-paper)
    compress_pod_axis: bool = False  # int8 compression on DCN hop
    role_policy: str = "memory_aware"  # load-balancer policy name


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | encdec | rwkv | hybrid | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    window: Optional[int] = None     # sliding-window attention size
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm_state: int = 0               # hybrid (hymba) SSM state size
    ssm_conv: int = 3                # depthwise conv width for SSM branch
    n_enc_layers: int = 0            # encdec: encoder depth
    frontend: Optional[FrontendConfig] = None
    attn_chunk: int = 1024           # kv-chunk for memory-efficient attention
    attn_chunk_threshold: int = 1024 # use chunked attention for seq > this
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 128
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    optimizer: str = "adamw"         # adamw | adafactor | sgdm
    remat: bool = True
    fl: FLConfig = field(default_factory=FLConfig)
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode with O(1)-in-seq state (window / SSM / linear)?"""
        return (self.window is not None) or self.family in ("rwkv", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (whisper is enc-dec)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# Input shapes (assigned)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether the (arch, shape) cell is well-defined (assignment rules)."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention; %s is full-attention" % arch.name
    return True, ""


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    # import side-effect registers every assigned architecture
    from repro_torch.configs import (  # noqa: F401
        kimi_k2_1t_a32b, mixtral_8x22b, whisper_small, internlm2_20b,
        qwen1_5_4b, h2o_danube_3_4b, qwen2_7b, rwkv6_7b, internvl2_2b,
        hymba_1_5b,
    )
    _LOADED = True


def smoke_config(arch: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw: dict[str, Any] = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=min(arch.n_kv_heads, 2) or 2,
        d_ff=128, vocab=256, head_dim=16, attn_chunk=32, attn_chunk_threshold=64,
        remat=False, rwkv_chunk=8,
    )
    if arch.family == "rwkv":
        kw.update(rwkv_head_dim=16, n_heads=4, n_kv_heads=4)
    if arch.moe is not None:
        kw["moe"] = dataclasses.replace(
            arch.moe, n_experts=4, top_k=2, d_ff_expert=32,
            n_shared_experts=min(arch.moe.n_shared_experts, 1),
            first_k_dense=min(arch.moe.first_k_dense, 1), d_ff_dense=64)
    if arch.n_enc_layers:
        kw["n_enc_layers"] = 2
    if arch.frontend is not None:
        kw["frontend"] = dataclasses.replace(arch.frontend, n_tokens=8, feat_dim=64)
    if arch.window is not None:
        kw["window"] = 32
    if arch.ssm_state:
        kw["ssm_state"] = 4
    return arch.replace(name=arch.name + "-smoke", **kw)
