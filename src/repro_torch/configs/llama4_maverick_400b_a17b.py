"""Llama 4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family].

48 layers, d_model=5120, 40 heads (GQA kv=8, head_dim=128), dense d_ff=8192
(shared expert) with MoE 128 experts top-1, vocab=202048.  Early-fusion
multimodal: the vision encoder is a stub frontend providing projected patch
embeddings merged into the token stream.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    activation="swiglu",
    tie_embeddings=False,
    rope_theta=500_000.0,
    attn_pattern=("global",),
    num_experts=128,
    experts_per_token=1,
    moe_d_ff=8192,
    moe_period=2,  # interleaved dense/MoE layers (400B total, ~17B active)
    moe_shared_expert=True,
    frontend="vision",
    frontend_tokens=256,
)
