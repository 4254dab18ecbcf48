"""Phi-3 Medium 14B [arXiv:2404.14219].

40 layers, d_model=5120, 40 heads (GQA kv=10, head_dim=128), d_ff=17920,
vocab=100352.  RoPE + SwiGLU + GQA, full (global) attention.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    citation="arXiv:2404.14219",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100_352,
    activation="swiglu",
    tie_embeddings=False,
    rope_theta=10_000.0,
    attn_pattern=("global",),
)
