"""qwen2-7b [arXiv:2407.10671; hf]
28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 — GQA, QKV bias."""

from .base import ModelConfig, register

register(ModelConfig(
    name="qwen2-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
))

register(ModelConfig(
    name="qwen2-7b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, qkv_bias=True, rope_theta=1e6,
))
