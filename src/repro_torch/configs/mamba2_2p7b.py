"""Mamba2 2.7B [arXiv:2405.21060].

64 layers, d_model=2560, attention-free, ssm_state=128, vocab=50280.
SSD (state-space duality) chunked scan.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    citation="arXiv:2405.21060",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    tie_embeddings=True,
    ssm_state_size=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    ssm_ngroups=1,
)
