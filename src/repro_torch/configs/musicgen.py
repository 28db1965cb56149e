"""musicgen-medium [arXiv:2306.05284; hf]
48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048 — decoder-only over
EnCodec tokens with cross-attention to text conditioning.

Modality frontend is a STUB per assignment: input_specs() provides
precomputed frame embeddings (B, S, d_model) and a conditioning sequence
(B, 64, d_model); only the transformer backbone is modeled.  MusicGen's FFN
is non-gated GELU; we keep the gated form used framework-wide and note the
3/2 FLOP difference in DESIGN.md §Arch-applicability."""

from .base import ModelConfig, register

register(ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048, norm="layernorm", act="gelu",
    cross_attn_every=1, num_cond_tokens=64, frontend="embeddings",
    pq_head=False,   # vocab 2048 — approximate MIPS head does not pay
))

register(ModelConfig(
    name="musicgen-medium-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=128, norm="layernorm", act="gelu",
    cross_attn_every=1, num_cond_tokens=8, frontend="embeddings",
    pq_head=False,
))
