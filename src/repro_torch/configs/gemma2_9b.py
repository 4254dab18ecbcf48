"""Gemma 2 9B [arXiv:2408.00118].

42 layers, d_model=3584, 16 heads (GQA kv=8, head_dim=256), d_ff=14336,
vocab=256000.  Local(4096-window)/global alternating attention, attention
logit soft-capping 50.0 and final logit soft-capping 30.0, GeGLU MLP.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    citation="arXiv:2408.00118",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256_000,
    activation="geglu",
    tie_embeddings=True,
    rope_theta=10_000.0,
    attn_pattern=("local", "global"),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
)
