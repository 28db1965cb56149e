"""recurrentgemma-9b [arXiv:2402.19427; unverified]
38L d_model=4096 16H... pattern: (RG-LRU, RG-LRU, local-attn) 1:2;
local window 2048, MQA (kv=1), d_ff=12288 (GeGLU), vocab=256000,
lru_width=4096.  38 = 12×3 + 2 ⇒ two trailing RG-LRU layers."""

from .base import ModelConfig, register

register(ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256000, act="gelu", rope_theta=1e4,
    rglru_pattern=3, local_window=2048, lru_width=4096,
))

register(ModelConfig(
    name="recurrentgemma-9b-smoke", family="hybrid",
    num_layers=5, d_model=64, num_heads=4, num_kv_heads=1,
    d_ff=128, vocab_size=512, act="gelu",
    rglru_pattern=3, local_window=32, lru_width=64,
))
