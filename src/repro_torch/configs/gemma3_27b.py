"""Gemma 3 27B [hf:google/gemma-3-1b-pt family].

62 layers, d_model=5376, 32 heads (GQA kv=16, head_dim=128), d_ff=21504,
vocab=262144.  5 local (1024-window) : 1 global attention pattern, qk-norm,
128k context (extended here to the long_500k shape via the sliding-window
local layers).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    citation="hf:google/gemma-3-1b-pt",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262_144,
    activation="geglu",
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    attn_pattern=("local", "local", "local", "local", "local", "global"),
    sliding_window=1024,
    qk_norm=True,
)
