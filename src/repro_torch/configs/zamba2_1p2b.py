"""Zamba2 1.2B [arXiv:2411.15242].

38 Mamba2 layers, d_model=2048, shared attention block (32 heads, kv=32,
head_dim=64, d_ff=8192) fired periodically over the Mamba2 trunk,
ssm_state=64, vocab=32000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    citation="arXiv:2411.15242",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32_000,
    activation="swiglu",
    tie_embeddings=True,
    rope_theta=10_000.0,
    attn_pattern=("global",),
    sliding_window=0,
    ssm_state_size=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    hybrid_attn_period=6,
)
