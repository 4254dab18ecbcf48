"""DeepSeek-R1-Distill-Qwen-1.5B — the paper's own evaluation family
[Qwen2 technical report, arXiv:2407.10671; distilled per arXiv:2501.12948].

28 layers, d_model=1536, 12 heads (GQA kv=2, head_dim=128), d_ff=8960,
vocab=151936.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen-1.5b",
    family="dense",
    citation="arXiv:2407.10671",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    activation="swiglu",
    tie_embeddings=True,
    rope_theta=10_000.0,
    attn_pattern=("global",),
)
