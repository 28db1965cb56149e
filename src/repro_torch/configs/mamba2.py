"""mamba2-780m [arXiv:2405.21060; unverified]
48L d_model=1536 (attention-free) vocab=50280, SSD: d_state=128,
expand=2 (d_inner=3072), headdim=64 (48 heads), conv=4, chunk=256."""

from .base import ModelConfig, register

register(ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256, ssm_conv=4,
))

register(ModelConfig(
    name="mamba2-780m-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=512,
    ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_chunk=16, ssm_conv=4,
))
