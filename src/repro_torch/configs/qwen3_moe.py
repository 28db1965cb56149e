"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B; hf]
94L d_model=4096 64H (GQA kv=4, head_dim=128) moe_d_ff=1536 vocab=151936,
MoE 128 experts top-8 (no shared experts)."""

from .base import ModelConfig, register

register(ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936, qkv_bias=False, rope_theta=1e6,
    num_experts=128, num_experts_per_tok=8, num_shared_experts=0,
    moe_d_ff=1536,
))

register(ModelConfig(
    name="qwen3-moe-235b-a22b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=512, rope_theta=1e6,
    num_experts=8, num_experts_per_tok=2, num_shared_experts=0, moe_d_ff=96,
))
