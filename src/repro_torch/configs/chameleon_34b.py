"""Chameleon 34B [arXiv:2405.09818].

48 layers, d_model=8192, 64 heads (GQA kv=8, head_dim=128), d_ff=22016,
vocab=65536.  Early-fusion: image VQ codes live in the token vocabulary, so
the backbone consumes a single mixed token stream (the VQ tokenizer is the
stubbed frontend).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    citation="arXiv:2405.09818",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65_536,
    activation="swiglu",
    tie_embeddings=False,
    rope_theta=10_000.0,
    attn_pattern=("global",),
    qk_norm=True,  # chameleon uses qk-norm for stability
    frontend="vision",
    frontend_tokens=0,  # VQ image tokens are ordinary vocabulary tokens
)
