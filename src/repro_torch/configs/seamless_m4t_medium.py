"""SeamlessM4T Medium [arXiv:2308.11596].

Encoder-decoder: 12 encoder + 12 decoder layers, d_model=1024, 16 heads
(kv=16, head_dim=64), d_ff=4096, vocab=256206.  The speech frontend
(mel-spectrogram + conv feature extractor) is a stub — ``input_specs``
provides precomputed frame embeddings for the encoder.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    citation="arXiv:2308.11596",
    num_layers=12,  # decoder layers
    num_encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256_206,
    activation="gelu",
    tie_embeddings=True,
    rope_theta=10_000.0,
    attn_pattern=("global",),
    frontend="audio",
    frontend_tokens=0,  # encoder input IS the frame-embedding sequence
)
