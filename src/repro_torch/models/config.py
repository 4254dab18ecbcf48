"""Model configuration for the repro model zoo.

One ``ModelConfig`` describes every architecture family in the assigned pool:
dense decoder-only transformers (GQA / RoPE / SwiGLU, local:global attention
patterns, logit soft-capping), MoE variants (top-k routing), Mamba2 SSD,
Zamba2-style hybrids, encoder-decoder (audio) backbones and early-fusion
multimodal backbones.  Modality frontends are stubs per the assignment: the
backbone consumes precomputed frame/patch embeddings.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    citation: str = ""

    # trunk
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0  # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    activation: str = "swiglu"  # swiglu | geglu | gelu
    tie_embeddings: bool = True
    norm_eps: float = 1e-6

    # attention details
    rope_theta: float = 10_000.0
    attn_pattern: Tuple[str, ...] = ("global",)  # cycled over layers
    sliding_window: int = 0  # tokens, for 'local' layers (0 = disabled)
    attn_logit_softcap: float = 0.0  # 0 = disabled (gemma2: 50.0)
    final_logit_softcap: float = 0.0  # 0 = disabled (gemma2: 30.0)
    qk_norm: bool = False  # gemma3-style

    # MoE
    num_experts: int = 0  # 0 = dense FFN
    experts_per_token: int = 0
    moe_d_ff: int = 0  # 0 -> d_ff
    moe_period: int = 1  # MoE FFN every k-th layer (llama4: 2 — interleaved)
    moe_shared_expert: bool = False  # dense shared expert on MoE layers
    router_aux_coef: float = 0.01
    moe_capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state_size: int = 0  # 0 = no ssm layers
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_ngroups: int = 1

    # hybrid (zamba2-style): period at which the shared attention block fires
    hybrid_attn_period: int = 0  # 0 = no shared attention block

    # encoder-decoder (seamless-style)
    num_encoder_layers: int = 0  # 0 = decoder-only

    # multimodal stub frontend: backbone consumes precomputed embeddings
    frontend: str = "none"  # none | vision | audio
    frontend_tokens: int = 0  # number of prefix embedding positions

    # ---- derived ----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.num_heads))

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if the arch can serve long_500k (sub-quadratic story)."""
        if self.family in ("ssm", "hybrid"):
            return True
        # dense archs qualify only with a native sliding-window variant
        return self.sliding_window > 0

    def layer_kind(self, i: int) -> str:
        """Attention kind for layer i (dense trunk): 'local' or 'global'."""
        return self.attn_pattern[i % len(self.attn_pattern)]

    def num_params(self) -> int:
        """Approximate parameter count (used for roofline MODEL_FLOPS)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        n = V * d  # embeddings
        if not self.tie_embeddings:
            n += V * d
        per_layer = 0
        if self.family == "ssm":
            di = self.ssm_d_inner
            ng, ss = self.ssm_ngroups, self.ssm_state_size
            nh = self.ssm_nheads
            # in_proj: d -> 2*di + 2*ng*ss + nh ; out_proj: di -> d
            per_layer = d * (2 * di + 2 * ng * ss + nh) + di * d
            per_layer += self.ssm_conv_width * (di + 2 * ng * ss)
            per_layer += 2 * nh + di  # A_log, D, norm
            n += L * per_layer
        else:
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.num_experts:
                n_moe = L // self.moe_period
                n_dense = L - n_moe
                ff_moe = 3 * d * self.resolved_moe_d_ff * self.num_experts
                ff_moe += d * self.num_experts  # router
                if self.moe_shared_expert:
                    ff_moe += 3 * d * self.d_ff
                ff = (n_moe * ff_moe + n_dense * 3 * d * self.d_ff) / max(1, L)
            else:
                ff = 3 * d * self.d_ff
            per_layer = attn + ff + 2 * d
            if self.family == "hybrid":
                # mamba trunk + one shared attention block
                di = self.ssm_d_inner
                ng, ss = self.ssm_ngroups, self.ssm_state_size
                nh = self.ssm_nheads
                mamba = d * (2 * di + 2 * ng * ss + nh) + di * d
                n += L * mamba + (attn + 3 * d * self.d_ff)
            else:
                enc_dec_mult = 1
                if self.num_encoder_layers:
                    # decoder layers additionally carry cross-attention
                    n += self.num_encoder_layers * per_layer
                    n += L * (2 * d * self.kv_dim + d * self.q_dim + self.q_dim * d)
                n += L * per_layer * enc_dec_mult
        return int(n)

    def num_active_params(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.num_experts:
            return self.num_params()
        d, L = self.d_model, self.num_layers
        total = self.num_params()
        n_moe = L // self.moe_period
        ff_all = 3 * d * self.resolved_moe_d_ff * self.num_experts
        ff_active = 3 * d * self.resolved_moe_d_ff * max(1, self.experts_per_token)
        return int(total - n_moe * (ff_all - ff_active))


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized variant of the same family (<=2 layers, small dims)."""
    base = dict(
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        frontend_tokens=min(cfg.frontend_tokens, 8) if cfg.frontend_tokens else 0,
    )
    if cfg.num_experts:
        base.update(num_experts=min(4, cfg.num_experts), moe_d_ff=256)
    if cfg.ssm_state_size:
        base.update(ssm_state_size=16, ssm_head_dim=32, ssm_chunk=32)
    if cfg.num_encoder_layers:
        base.update(num_encoder_layers=2)
    if cfg.hybrid_attn_period:
        base.update(hybrid_attn_period=2)
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
