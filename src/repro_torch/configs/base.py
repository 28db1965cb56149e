"""Model / shape configuration system (the port's own copy of
``repro.configs``: the same dataclasses, fields and registry).

Every assigned architecture registers an exact `ModelConfig` plus a reduced
`smoke` variant (same family, tiny dims) in its own module; `get_config(name)`
resolves either (``<arch>`` or ``<arch>-smoke``).
"""

from __future__ import annotations

import dataclasses
import importlib

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "get_config", "list_archs",
           "register", "ARCH_IDS"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 => d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_fraction: float = 1.0
    norm: str = "rmsnorm"
    act: str = "silu"           # gated (SwiGLU/GeGLU per `act`)
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    # hybrid (RecurrentGemma / Griffin): pattern (rglru, rglru, attn)
    rglru_pattern: int = 0      # 0 = none; 3 = attn every 3rd layer
    local_window: int = 0
    lru_width: int = 0
    # cross-attention (VLM / audio conditioning)
    cross_attn_every: int = 0   # k => layer i has cross-attn if (i+1) % k == 0
    num_cond_tokens: int = 0    # conditioning sequence length (stub frontend)
    frontend: str = "tokens"    # tokens | embeddings (stub supplies embeddings)
    # compute
    dtype: str = "bfloat16"
    remat: bool = True
    unroll: bool = False   # python-loop the layer stack (roofline probes only)
    attn_chunk: int = 512  # banded-flash chunk (peak attn memory ∝ S·chunk)
    loss_chunk: int = 512  # seq chunk for xent (never materialize B,S,V f32)
    # beyond-paper optimization levers (§Perf hillclimbs; defaults = baseline)
    kv_repeat: int = 1     # replicate KV heads r× so hkv·r divides the TP
                           # axis (vLLM-style; 2× KV cache for full attn TP)
    moe_seq_combine: bool = False  # keep MoE combine seq-sharded through the
                                   # gate-weighted k-sum (smaller all-gather)
    params_bf16_cast: bool = False  # cast matrices to bf16 inside train_step
                                    # (FSDP all-gathers move half the bytes)
    moe_shardmap_combine: bool = False  # explicit shard_map combine: psum the
                                        # (B,S,D) partial AFTER the k-sum (GSPMD
                                        # otherwise all-reduces (B,A,D) f32)

    @property
    def effective_kv_heads(self) -> int:
        return self.num_kv_heads * self.kv_repeat
    # paper-technique head (PQ-approximated logits; DESIGN.md §4)
    pq_head: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "qwen3-moe-235b-a22b", "qwen2-moe-a2.7b", "qwen2-7b", "stablelm-1.6b",
    "qwen2.5-14b", "deepseek-67b", "musicgen-medium", "recurrentgemma-9b",
    "llama-3.2-vision-90b", "mamba2-780m",
]

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load_all():
    for mod in ("qwen3_moe", "qwen2_moe", "qwen2_7b", "stablelm", "qwen25_14b",
                "deepseek_67b", "musicgen", "recurrentgemma", "llama_vision",
                "mamba2"):
        importlib.import_module(f".{mod}", __package__)


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs(include_smoke: bool = False) -> list[str]:
    if not _REGISTRY:
        _load_all()
    return [k for k in _REGISTRY
            if include_smoke or not k.endswith("-smoke")]
