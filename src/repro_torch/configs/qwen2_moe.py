"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
24L d_model=2048 16H (GQA kv=16) moe_d_ff=1408 vocab=151936,
MoE 60 routed top-4 + 4 shared experts (shared intermediate 4*1408=5632)."""

from .base import ModelConfig, register

register(ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=151936, qkv_bias=True, rope_theta=1e6,
    num_experts=60, num_experts_per_tok=4, num_shared_experts=4,
    moe_d_ff=1408,
))

register(ModelConfig(
    name="qwen2-moe-a2.7b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=96, vocab_size=512, qkv_bias=True, rope_theta=1e6,
    num_experts=6, num_experts_per_tok=2, num_shared_experts=2, moe_d_ff=96,
))
