"""Grok-1 314B [hf:xai-org/grok-1].

64 layers, d_model=6144, 48 heads (GQA kv=8, head_dim=128), d_ff=32768,
vocab=131072, MoE 8 experts top-2.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    citation="hf:xai-org/grok-1",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131_072,
    activation="gelu",
    tie_embeddings=True,
    rope_theta=10_000.0,
    attn_pattern=("global",),
    attn_logit_softcap=30.0,  # grok uses attention logit capping
    final_logit_softcap=30.0,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=32768,
)
