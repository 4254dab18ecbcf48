"""Core neural-net building blocks: plain functions on tensors over dict
params, the PyTorch counterpart of ``repro.models.layers``.

Attention goes through one hook, ``set_attention_impl``.  Its default is
the hand-written kernel's wrapper, ``kernels.flash_attention``: the CUDA
kernel on a CUDA tensor, its plain version on a CPU tensor.
``blockwise_attention`` is the algorithmic reference (a port of the JAX
package's jnp online-softmax scan), used by the tests.

Context parallelism attends once per cp group, not per rank:
``attn_qkv`` forms a rank's q, k and v, ``group_attention`` runs the
group's attention through the second hook, ``set_group_attention_impl``
(default ``core.cp.ring_attention``; ``core.cp.allgather_attention`` is
its plain version), and ``attn_out`` projects each rank's output.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.cp import ring_attention
from repro_torch.kernels.flash_attention import NEG_INF, flash_attention

# masked cache positions, as in the JAX package
PAD_POSITION = -(10 ** 9)

_ATTN_IMPL = flash_attention
_GROUP_ATTN_IMPL = ring_attention


def set_attention_impl(fn):
    """Install ``fn(q, k, v, **kw)`` (``flash_attention``'s keyword
    signature) as the attention of ``attn_apply``; ``None`` restores the
    kernel.  Returns the impl it displaced, for the caller to restore."""
    global _ATTN_IMPL
    prev = _ATTN_IMPL
    _ATTN_IMPL = flash_attention if fn is None else fn
    return prev


def set_group_attention_impl(fn):
    """Install ``fn(qs, ks, vs, positions, segment_ids, **kw)``
    (``core.cp.ring_attention``'s signature) as the attention of a cp
    group; ``None`` restores the ring.  Returns the impl it displaced."""
    global _GROUP_ATTN_IMPL
    prev = _GROUP_ATTN_IMPL
    _GROUP_ATTN_IMPL = ring_attention if fn is None else fn
    return prev


# --------------------------------------------------------------------------
# initialization helpers
# --------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype, scale: float = 1.0):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / (fan_in ** 0.5)
    x = torch.randn(shape, generator=gen, device=gen.device)
    return (x * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype):
    x = torch.randn(shape, generator=gen, device=gen.device)
    return (x * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms / activations / rope
# --------------------------------------------------------------------------
def promoted_matmul(a, b):
    """``a @ b`` in the promoted type of the two, as a jnp product of mixed
    types computes (bf16 weights against an f32 activation)."""
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t) @ b.to(t)


def rms_norm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def softcap(x, cap: float):
    """Gemma2/grok-style logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    if name == "swiglu":
        return F.silu
    if name in ("geglu", "gelu"):
        return _gelu_tanh
    raise ValueError(name)


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S).  Split halves, not
    interleaved."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    angles = angles[..., None, :]  # broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# blockwise attention: the reference algorithm (online softmax over kv
# blocks), a port of repro.models.layers.blockwise_attention
# --------------------------------------------------------------------------
def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        logit_softcap: float = 0.0, q_positions=None,
                        kv_positions=None, q_segment_ids=None,
                        kv_segment_ids=None, block_kv: int = 512,
                        scale: Optional[float] = None):
    """q: (B, S, H, hd); k, v: (B, T, KH, hd) with H % KH == 0 (GQA).
    Loops over kv blocks carrying the online-softmax state (m, l, acc)."""
    B, S, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    dev = q.device
    if scale is None:
        scale = hd ** -0.5
    if q_positions is None:
        q_positions = torch.arange(S, device=dev).expand(B, S)
    if kv_positions is None:
        kv_positions = torch.arange(T, device=dev).expand(B, T)
    block_kv = min(block_kv, T)
    num_blocks = -(-T // block_kv)
    pad = num_blocks * block_kv - T
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=PAD_POSITION)
        if kv_segment_ids is not None:
            kv_segment_ids = F.pad(kv_segment_ids, (0, pad), value=-1)
    use_seg = q_segment_ids is not None and kv_segment_ids is not None

    qg = q.float().reshape(B, S, KH, G, hd) * scale
    m = torch.full((B, S, KH, G), NEG_INF, device=dev)
    l = torch.zeros((B, S, KH, G), device=dev)
    acc = torch.zeros((B, S, KH, G, hd), device=dev)
    for i in range(num_blocks):
        blk = slice(i * block_kv, (i + 1) * block_kv)
        kb, vb = k[:, blk].float(), v[:, blk].float()
        pb = kv_positions[:, blk]
        s = torch.einsum("bskgd,bckd->bskgc", qg, kb)
        if logit_softcap > 0.0:
            s = softcap(s, logit_softcap)
        rel = q_positions[:, :, None] - pb[:, None, :]
        mask = pb[:, None, :] >= 0
        if causal:
            mask = mask & (rel >= 0)
        if window > 0:
            mask = mask & (rel < window)
        if use_seg:
            mask = mask & (q_segment_ids[:, :, None]
                           == kv_segment_ids[:, blk][:, None, :])
        s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bskgc,bckd->bskgd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, S, H, hd).to(q.dtype)


# --------------------------------------------------------------------------
# attention layer (params + apply), GQA + rope + cache
# --------------------------------------------------------------------------
def attn_params(gen, cfg, dtype, prefix_shape=()):
    d, qd, kvd, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, prefix_shape + (d, qd), dtype),
        "wk": dense_init(gen, prefix_shape + (d, kvd), dtype),
        "wv": dense_init(gen, prefix_shape + (d, kvd), dtype),
        "wo": dense_init(gen, prefix_shape + (qd, d), dtype,
                         scale=1.0 / max(1, cfg.num_layers) ** 0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(prefix_shape + (hd,), dtype=dtype,
                                  device=gen.device)
        p["k_norm"] = torch.zeros(prefix_shape + (hd,), dtype=dtype,
                                  device=gen.device)
    return p


def attn_apply(cfg, p, x, *, window: int = 0, positions=None,
               segment_ids=None, cache=None, cache_index=None,
               causal: bool = True, cross_kv=None):
    """Self- (or cross-) attention of one layer.

    window: this layer's static sliding window (0 = global).
    cache: optional {"k": (B, T, KH, hd), "v": ...}.  The new k/v are
    written IN PLACE at ``cache_index`` (an int, or a (B,) tensor for
    per-row decode) and attention runs over the whole cache, positions
    past the write index masked.  Returns (out, cache).
    cross_kv: (k, v) of an encoder output, each (B, T, KH, hd): cross-
    attention (the encoder-decoder's).  q is projected (and q-normed
    under ``qk_norm``); k and v are used as given; no rope on either
    side, kv positions ``arange(T)``, no segment ids, not causal, no
    cache.
    """
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    if cross_kv is not None:
        if cache is not None:
            raise ValueError("cross-attention takes no cache")
        k, v = cross_kv
        out = _ATTN_IMPL(attn_q(cfg, p, x), k, v, causal=False,
                         window=window, logit_softcap=cfg.attn_logit_softcap,
                         q_positions=positions)
        return attn_out(p, out), None
    q, k, v = attn_qkv(cfg, p, x, positions)

    kv_positions = positions
    kv_segment_ids = segment_ids
    if cache is not None:
        T = cache["k"].shape[1]
        slots = torch.arange(T, device=x.device)
        if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
            # per-row write index (continuous batching): each row decodes
            # at its own position; rows past a slot's cursor hold stale kv
            # of a retired request, masked out exactly
            if S != 1:
                raise ValueError(f"vector cache_index requires single-token "
                                 f"decode, got S={S}")
            rows = torch.arange(B, device=x.device)
            idx = cache_index.long()
            cache["k"][rows, idx] = k[:, 0].to(cache["k"].dtype)
            cache["v"][rows, idx] = v[:, 0].to(cache["v"].dtype)
            last = idx[:, None]
        else:
            idx = int(cache_index)
            cache["k"][:, idx:idx + S] = k.to(cache["k"].dtype)
            cache["v"][:, idx:idx + S] = v.to(cache["v"].dtype)
            last = idx + S - 1
        kv_positions = torch.where(slots <= last, slots,
                                   PAD_POSITION).expand(B, T)
        k, v = cache["k"], cache["v"]
        kv_segment_ids = None
        segment_ids = None

    out = _ATTN_IMPL(q, k, v, causal=causal, window=window,
                     logit_softcap=cfg.attn_logit_softcap,
                     q_positions=positions, kv_positions=kv_positions,
                     q_segment_ids=segment_ids,
                     kv_segment_ids=kv_segment_ids)
    return attn_out(p, out), cache


def attn_q(cfg, p, x):
    """q (B, S, H, hd) of x (B, S, d): the projection and the q norm (no
    rope)."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    return q


def attn_qkv(cfg, p, x, positions):
    """q (B, S, H, hd), k and v (B, S, KH, hd) of x (B, S, d): the
    projections, the qk norm and rope at ``positions`` (B, S)."""
    B, S, _ = x.shape
    q = attn_q(cfg, p, x)
    k = (x @ p["wk"]).reshape(B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    v = (x @ p["wv"]).reshape(B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(p, out):
    """The output projection of an attention output (B, S, H, hd)."""
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ p["wo"]


def group_attention(cfg, qs, ks, vs, positions, segment_ids, *,
                    window: int = 0, causal: bool = True):
    """Causal self-attention of one cp group: every rank's q, k, v,
    positions and segment ids in, every rank's output out."""
    return _GROUP_ATTN_IMPL(qs, ks, vs, positions, segment_ids,
                            causal=causal, window=window,
                            logit_softcap=cfg.attn_logit_softcap)


# --------------------------------------------------------------------------
# MLP (dense FFN)
# --------------------------------------------------------------------------
def mlp_params(gen, cfg, dtype, prefix_shape=(), d_ff=None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    gated = cfg.activation in ("swiglu", "geglu")
    p = {}
    if gated:
        p["w_gate"] = dense_init(gen, prefix_shape + (d, f), dtype)
    p["w_up"] = dense_init(gen, prefix_shape + (d, f), dtype)
    p["w_down"] = dense_init(gen, prefix_shape + (f, d), dtype,
                             scale=1.0 / max(1, cfg.num_layers) ** 0.5)
    return p


def mlp_apply(cfg, p, x):
    act = activation_fn(cfg.activation)
    up = x @ p["w_up"]
    if "w_gate" in p:
        h = act(x @ p["w_gate"]) * up
    else:
        h = act(up)
    return h @ p["w_down"]
