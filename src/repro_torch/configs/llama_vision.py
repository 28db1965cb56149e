"""llama-3.2-vision-90b [hf:meta-llama/Llama-3.2-11B-Vision; unverified]
100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256 — cross-attn image
layers every 5th layer (20 of 100).

Vision frontend is a STUB per assignment: input_specs() provides precomputed
image patch embeddings (B, 1024, d_model) consumed by the cross-attention
layers; only the language backbone is modeled."""

from .base import ModelConfig, register

register(ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256, rope_theta=5e5,
    cross_attn_every=5, num_cond_tokens=1024,
))

register(ModelConfig(
    name="llama-3.2-vision-90b-smoke", family="vlm",
    num_layers=5, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, rope_theta=5e5,
    cross_attn_every=5, num_cond_tokens=16,
))
