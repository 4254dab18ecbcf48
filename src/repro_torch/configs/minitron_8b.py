"""Minitron 8B (pruned Nemotron-4) [arXiv:2407.14679].

32 layers, d_model=4096, 32 heads (GQA kv=8, head_dim=128), d_ff=16384,
vocab=256000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    citation="arXiv:2407.14679",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256_000,
    activation="swiglu",  # squared-relu in the original; swiglu variant here
    tie_embeddings=False,
    rope_theta=10_000.0,
    attn_pattern=("global",),
)
