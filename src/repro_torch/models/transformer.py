"""Model assembly, every family (dense, vlm, moe, ssm, hybrid and the
audio encoder-decoder): the PyTorch counterpart of
``repro.models.transformer``.

    init_params(cfg, gen, dtype)                   -> params dict
    apply(cfg, params, batch, ...)                 -> (logits, aux, caches)
    init_cache(cfg, batch, max_len, dtype, device) -> decode caches dict
    loss(cfg, params, batch, ...)                  -> (loss, metrics)
    loss_ranks(cfg, params_list, batches, ...)     -> [(loss, metrics)]

The params dict has the JAX tree's key names, with the per-layer leaves
stacked on leading axes, so ``bridge.params_from_numpy`` carries a JAX
tree over as it is.  The layer trunk is a Python loop over those axes;
each layer gets its sliding window as a Python int, which is what the
attention kernel needs.

The ssm family (mamba2) stacks ``{"norm", "mamba"}`` blocks under
``layers``; its caches are ``{"conv": (L, B, W-1, conv_dim), "ssm": (L, B,
h, p, n)}``, and ``apply`` returns new caches (the ones passed in are not
written).  As in the reference, the ssm forward reads no positions and no
segment ids: the conv and the scan run across packed samples.

The hybrid family (zamba2) has ``n_super = L // P`` super-layers of P
mamba blocks (``mamba``, stacked ``(n_super, P, ...)``), then a tail of
``L % P`` mamba blocks (``mamba_tail``, ``(tail, ...)``, absent when the
tail is empty), and one dense block, ``shared_attn`` (not stacked), that
runs after every super-layer with the config's sliding window (0 =
global).  The mamba blocks read no positions and no segment ids; the
shared block reads both.  Its caches are ``{"mamba": {"conv", "ssm"}
(n_super, P, ...), "attn": {"k", "v"} (n_super, B, T, KH, hd), one per
invocation, written in place, "tail": {"conv", "ssm"} (tail, ...) or
None}``.  As the reference does, the shared block takes the hidden state
alone (no concatenation with the embedding, no per-invocation LoRA).

The vlm family (chameleon) is the dense trunk; a batch may carry
``vision_embeds`` (B, n, d), the stub frontend's patch embeddings, written
over the first n positions when the config has a vision frontend with
``frontend_tokens`` > 0 (chameleon has none: its image codes are tokens).

The moe family has ``n_super = L // P`` super-layers of P = ``moe_period``
layers: P-1 dense blocks (``layers/dense``, stacked ``(n_super, P-1,
...)``, absent for P = 1) and then one moe block (``layers/moe``,
``(n_super, ...)``: attention, the routed experts ``moe``, and
``shared_mlp`` when the config has a shared expert), every layer global.
Its caches are ``{"moe": {"k", "v", "router_counts"}, "dense": {"k",
"v"}}``: attention KV written in place, and the router's (n_super, B, k,
E) int32 tally of tokens per expert, returned anew, which makes prefill
plus decode drop what the full forward drops (``moe.moe_apply``).
``apply`` returns the summed router aux loss of the moe blocks.

The audio family (seamless-m4t) is an encoder-decoder.  ``enc_layers``
(num_encoder_layers, ...) are dense blocks with bidirectional self-
attention at positions ``arange(S)`` over the stub frontend's frame
embeddings (a batch's ``encoder_embeds``, (B, S_enc, d)), then
``enc_final_norm``; ``dec_layers`` (L, ...) are dense blocks (window 0),
each followed by cross-attention (``cross_norm``, ``cross``) to the
encoder output, whose k and v every block projects anew at every step,
as the reference does.  Its caches are ``{"self": {"k", "v"} (L, B, T,
KH, hd), written in place, "enc_out": (B, S_enc, d) or None}``: a
forward whose batch carries ``encoder_embeds`` encodes them and returns
the encoder output in the new caches (the prefill); one without reads
``caches["enc_out"]`` (the decode steps).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import fsdp
from repro_torch.core.odc import prefetch_scan
from repro_torch.core.ranks import cp_groups
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig


def _require_ported(cfg: ModelConfig):
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch "
            f"(ROADMAP.md, queue 1 item 2); the port runs the dense, vlm, "
            f"moe, ssm, hybrid and audio families")


def is_moe(cfg: ModelConfig) -> bool:
    """The moe trunk (the reference's ``cfg.num_experts`` branch)."""
    return bool(cfg.num_experts) and cfg.family not in ("ssm", "hybrid",
                                                        "audio")


def require_cp(cfg: ModelConfig):
    """Refuse context parallelism for a family that has no cp path."""
    if is_moe(cfg) or (cfg.family == "vlm" and cfg.frontend_tokens):
        raise NotImplementedError(
            f"{cfg.name}: context parallelism of the {cfg.family} family is "
            f"not ported (ROADMAP.md, queue 1 item 12): the router's "
            f"capacity and the vision stub's positions are per sequence, "
            f"not per sequence shard")
    if cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name}: context parallelism of the audio family is not "
            f"ported (ROADMAP.md, queue 1 item 14): the decoder's cross-"
            f"attention would read an encoder output replicated over the "
            f"cp group while its tokens are sharded")
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: context parallelism of the {cfg.family} family is "
            f"not ported (ROADMAP.md, queue 1 item 5): a scan split over the "
            f"cp ranks (the {cfg.family} family's mamba blocks) needs its "
            f"state passed between them")


def moe_split(cfg: ModelConfig):
    """(P, n_super) of a moe config: super-layers of P-1 dense blocks and
    one moe block (a remainder of L % P layers is dropped, as in the
    reference)."""
    P = cfg.moe_period
    return P, cfg.num_layers // P


def hybrid_split(cfg: ModelConfig):
    """(P, n_super, tail) of a hybrid config."""
    P = cfg.hybrid_attn_period
    return (P,) + divmod(cfg.num_layers, P)


# ===========================================================================
# parameter init
# ===========================================================================
def _dense_block_params(gen, cfg, dtype, prefix_shape=()):
    zeros = lambda: torch.zeros(prefix_shape + (cfg.d_model,), dtype=dtype,
                                device=gen.device)
    return {
        "attn_norm": zeros(),
        "attn": L.attn_params(gen, cfg, dtype, prefix_shape),
        "mlp_norm": zeros(),
        "mlp": L.mlp_params(gen, cfg, dtype, prefix_shape),
    }


def _moe_block_params(gen, cfg, dtype, prefix_shape=()):
    zeros = lambda: torch.zeros(prefix_shape + (cfg.d_model,), dtype=dtype,
                                device=gen.device)
    p = {
        "attn_norm": zeros(),
        "attn": L.attn_params(gen, cfg, dtype, prefix_shape),
        "mlp_norm": zeros(),
        "moe": moe_mod.moe_params(gen, cfg, dtype, prefix_shape),
    }
    if cfg.moe_shared_expert:
        p["shared_mlp"] = L.mlp_params(gen, cfg, dtype, prefix_shape)
    return p


def _mamba_block_params(gen, cfg, dtype, prefix_shape=()):
    return {
        "norm": torch.zeros(prefix_shape + (cfg.d_model,), dtype=dtype,
                            device=gen.device),
        "mamba": ssm_mod.mamba2_params(gen, cfg, dtype, prefix_shape),
    }


def _encdec_dec_params(gen, cfg, dtype, prefix_shape=()):
    """A decoder block: a dense block, then cross-attention."""
    p = _dense_block_params(gen, cfg, dtype, prefix_shape)
    p["cross_norm"] = torch.zeros(prefix_shape + (cfg.d_model,), dtype=dtype,
                                  device=gen.device)
    p["cross"] = L.attn_params(gen, cfg, dtype, prefix_shape)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype=torch.float32):
    """Random weights drawn from ``gen``, on ``gen``'s device."""
    _require_ported(cfg)
    params = {"embed": L.embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                    dtype)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                         dtype)
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                       device=gen.device)
    if cfg.family == "hybrid":
        P, n_super, tail = hybrid_split(cfg)
        params["mamba"] = _mamba_block_params(gen, cfg, dtype, (n_super, P))
        if tail:
            params["mamba_tail"] = _mamba_block_params(gen, cfg, dtype,
                                                       (tail,))
        params["shared_attn"] = _dense_block_params(gen, cfg, dtype)
        return params
    if cfg.family == "audio":
        params["enc_layers"] = _dense_block_params(
            gen, cfg, dtype, (cfg.num_encoder_layers,))
        params["enc_final_norm"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                               device=gen.device)
        params["dec_layers"] = _encdec_dec_params(gen, cfg, dtype,
                                                  (cfg.num_layers,))
        return params
    if is_moe(cfg):
        P, n_super = moe_split(cfg)
        params["layers"] = {"moe": _moe_block_params(gen, cfg, dtype,
                                                     (n_super,))}
        if P > 1:
            params["layers"]["dense"] = _dense_block_params(
                gen, cfg, dtype, (n_super, P - 1))
        return params
    block = _mamba_block_params if cfg.family == "ssm" \
        else _dense_block_params
    params["layers"] = block(gen, cfg, dtype, (cfg.num_layers,))
    return params


def _mamba_block_shapes(cfg, meta, pre):
    d, di, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_nheads
    gn = cfg.ssm_ngroups * cfg.ssm_state_size
    mamba = {"in_proj": meta(*pre, d, 2 * di + 2 * gn + nh),
             "conv_w": meta(*pre, cfg.ssm_conv_width, di + 2 * gn),
             "conv_b": meta(*pre, di + 2 * gn), "dt_bias": meta(*pre, nh),
             "A_log": meta(*pre, nh), "D": meta(*pre, nh),
             "gate_norm": meta(*pre, di), "out_proj": meta(*pre, di, d)}
    return {"norm": meta(*pre, d), "mamba": mamba}


def _attn_shapes(cfg, meta, pre):
    d, qd, kvd, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, \
        cfg.resolved_head_dim
    attn = {"wq": meta(*pre, d, qd), "wk": meta(*pre, d, kvd),
            "wv": meta(*pre, d, kvd), "wo": meta(*pre, qd, d)}
    if cfg.qk_norm:
        attn["q_norm"] = meta(*pre, hd)
        attn["k_norm"] = meta(*pre, hd)
    return attn


def _mlp_shapes(cfg, meta, pre, *lead, d_ff=None):
    """An FFN's leaves; ``lead`` dims (the experts) before each matrix."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    mlp = {"w_up": meta(*pre, *lead, d, f), "w_down": meta(*pre, *lead, f, d)}
    if cfg.activation in ("swiglu", "geglu"):
        mlp["w_gate"] = meta(*pre, *lead, d, f)
    return mlp


def _dense_block_shapes(cfg, meta, pre):
    d = cfg.d_model
    return {"attn_norm": meta(*pre, d), "attn": _attn_shapes(cfg, meta, pre),
            "mlp_norm": meta(*pre, d), "mlp": _mlp_shapes(cfg, meta, pre)}


def _moe_block_shapes(cfg, meta, pre):
    d, E = cfg.d_model, cfg.num_experts
    moe = _mlp_shapes(cfg, meta, pre, E, d_ff=cfg.resolved_moe_d_ff)
    moe["router"] = meta(*pre, d, E)
    block = {"attn_norm": meta(*pre, d), "attn": _attn_shapes(cfg, meta, pre),
             "mlp_norm": meta(*pre, d), "moe": moe}
    if cfg.moe_shared_expert:
        block["shared_mlp"] = _mlp_shapes(cfg, meta, pre)
    return block


def param_shapes(cfg: ModelConfig):
    """The tree ``init_params`` builds, as meta tensors (shapes only)."""
    _require_ported(cfg)
    meta = lambda *shape: torch.empty(shape, device="meta")
    params = {"embed": meta(cfg.vocab_size, cfg.d_model)}
    if not cfg.tie_embeddings:
        params["lm_head"] = meta(cfg.d_model, cfg.vocab_size)
    params["final_norm"] = meta(cfg.d_model)
    if cfg.family == "hybrid":
        P, n_super, tail = hybrid_split(cfg)
        params["mamba"] = _mamba_block_shapes(cfg, meta, (n_super, P))
        if tail:
            params["mamba_tail"] = _mamba_block_shapes(cfg, meta, (tail,))
        params["shared_attn"] = _dense_block_shapes(cfg, meta, ())
    elif cfg.family == "ssm":
        params["layers"] = _mamba_block_shapes(cfg, meta, (cfg.num_layers,))
    elif cfg.family == "audio":
        params["enc_layers"] = _dense_block_shapes(
            cfg, meta, (cfg.num_encoder_layers,))
        params["enc_final_norm"] = meta(cfg.d_model)
        dec = _dense_block_shapes(cfg, meta, (cfg.num_layers,))
        dec["cross_norm"] = meta(cfg.num_layers, cfg.d_model)
        dec["cross"] = _attn_shapes(cfg, meta, (cfg.num_layers,))
        params["dec_layers"] = dec
    elif is_moe(cfg):
        P, n_super = moe_split(cfg)
        params["layers"] = {"moe": _moe_block_shapes(cfg, meta, (n_super,))}
        if P > 1:
            params["layers"]["dense"] = _dense_block_shapes(
                cfg, meta, (n_super, P - 1))
    else:
        params["layers"] = _dense_block_shapes(cfg, meta, (cfg.num_layers,))
    return params


# ===========================================================================
# forward
# ===========================================================================
def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def layer_window(cfg: ModelConfig, i: int) -> int:
    """Layer i's sliding window (0 = global), a Python int."""
    return cfg.sliding_window if cfg.layer_kind(i) == "local" else 0


def _mlp_residual(cfg, lp, x):
    h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + L.mlp_apply(cfg, lp["mlp"], h)


def _apply_dense_block(cfg, lp, x, *, window, positions, segment_ids, cache,
                       cache_index):
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    a, cache = L.attn_apply(cfg, lp["attn"], h, window=window,
                            positions=positions, segment_ids=segment_ids,
                            cache=cache, cache_index=cache_index)
    return _mlp_residual(cfg, lp, x + a), cache


def _apply_cp_blocks(cfg, lps, xs, batches, *, window, cp):
    """One dense block over every rank, with attention run once per cp
    group of ``cp`` adjacent ranks (``layers.group_attention``)."""
    qkv = [L.attn_qkv(cfg, lp["attn"],
                      L.rms_norm(x, lp["attn_norm"], cfg.norm_eps),
                      b.get("positions"))
           for lp, x, b in zip(lps, xs, batches)]
    outs = []
    for grp in cp_groups(len(xs), cp):
        outs += L.group_attention(
            cfg, [qkv[r][0] for r in grp], [qkv[r][1] for r in grp],
            [qkv[r][2] for r in grp],
            [batches[r].get("positions") for r in grp],
            [batches[r].get("segment_ids") for r in grp], window=window)
    return [_mlp_residual(cfg, lp, x + L.attn_out(lp["attn"], a))
            for lp, x, a in zip(lps, xs, outs)]


def _encoder_block(cfg, lp, x):
    """One encoder block: bidirectional self-attention at positions
    ``arange(S)`` (no segment ids), then the MLP."""
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    a, _ = L.attn_apply(cfg, lp["attn"], h, causal=False)
    return _mlp_residual(cfg, lp, x + a)


def _apply_dec_block(cfg, lp, x, enc_out, *, positions, segment_ids, cache,
                     cache_index):
    """One decoder block: a dense block (window 0), then cross-attention
    on ``cross_norm(x)`` to ``enc_out`` (B, S_enc, d), whose k and v are
    projected here."""
    x, cache = _apply_dense_block(cfg, lp, x, window=0, positions=positions,
                                  segment_ids=segment_ids, cache=cache,
                                  cache_index=cache_index)
    h = L.rms_norm(x, lp["cross_norm"], cfg.norm_eps)
    B, T, _ = enc_out.shape
    shape = (B, T, cfg.num_kv_heads, cfg.resolved_head_dim)
    kv = ((enc_out @ lp["cross"]["wk"]).reshape(shape),
          (enc_out @ lp["cross"]["wv"]).reshape(shape))
    c, _ = L.attn_apply(cfg, lp["cross"], h, positions=positions,
                        cross_kv=kv)
    return x + c, cache


def _enc_input(params, batch):
    """The frame embeddings, in the parameters' type."""
    return batch["encoder_embeds"].to(params["enc_final_norm"].dtype)


def _apply_mamba_block(cfg, lp, x, *, cache):
    h = L.rms_norm(x, lp["norm"], cfg.norm_eps)
    out, cache = ssm_mod.mamba2_apply(cfg, lp["mamba"], h, cache=cache)
    return x + out, cache


def _logits(cfg, params, x):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    logits = L.promoted_matmul(x, head)
    if cfg.final_logit_softcap > 0:
        logits = L.softcap(logits, cfg.final_logit_softcap)
    return logits


def _embed(cfg, params, batch):
    x = params["embed"][batch["tokens"]]
    if cfg.frontend != "none" and cfg.frontend_tokens \
            and "vision_embeds" in batch:
        ve = batch["vision_embeds"]
        x = torch.cat([ve.to(x.dtype), x[:, ve.shape[1]:]], dim=1)
    return x


def _moe_attention(cfg, lp, x, *, positions, segment_ids, cache=None,
                   cache_index=None):
    """A moe block up to its experts: (the attention residual, the normed
    input of the experts).  A KV cache is written in place."""
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    a, _ = L.attn_apply(cfg, lp["attn"], h, window=0, positions=positions,
                        segment_ids=segment_ids, cache=cache,
                        cache_index=cache_index)
    x = x + a
    return x, L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)


def _apply_moe_block(cfg, lp, x, *, positions, segment_ids, cache,
                     cache_index, moe_groups):
    """One moe block: attention, then the routed experts (and the shared
    expert) on the normed residual.  With a cache, the router tally it
    carries is passed to ``moe_apply`` and comes back updated in the new
    cache, the KV written in place.  Returns (x, cache, aux)."""
    if cache is None:
        x, h = _moe_attention(cfg, lp, x, positions=positions,
                              segment_ids=segment_ids)
        ffn, aux = moe_mod.moe_apply(cfg, lp["moe"], h, groups=moe_groups)
        return x + _shared(cfg, lp, h, ffn), None, aux
    kv = {"k": cache["k"], "v": cache["v"]}
    x, h = _moe_attention(cfg, lp, x, positions=positions,
                          segment_ids=segment_ids, cache=kv,
                          cache_index=cache_index)
    ffn, aux, counts = moe_mod.moe_apply(
        cfg, lp["moe"], h, groups=moe_groups,
        router_counts=cache["router_counts"], capacity_len=kv["k"].shape[1])
    return x + _shared(cfg, lp, h, ffn), dict(kv, router_counts=counts), aux


def _shared(cfg, lp, h, ffn):
    """The routed experts' output plus the shared expert's, if any."""
    if "shared_mlp" in lp:
        return ffn + L.mlp_apply(cfg, lp["shared_mlp"], h)
    return ffn


def _forward_dense(cfg, params, batch, caches, cache_index):
    x = _embed(cfg, params, batch)
    positions = batch.get("positions")
    segment_ids = batch.get("segment_ids")
    for i in range(cfg.num_layers):
        cache = None
        if caches is not None:
            cache = {"k": caches["k"][i], "v": caches["v"][i]}  # views
        x, _ = _apply_dense_block(
            cfg, _layer(params["layers"], i), x, window=layer_window(cfg, i),
            positions=positions, segment_ids=segment_ids, cache=cache,
            cache_index=cache_index)
    return x


def _forward_ssm(cfg, params, batch, caches):
    """The mamba trunk; with caches, the stacked new caches of every
    layer (prefill or one decode step, by the sequence length)."""
    x = _embed(cfg, params, batch)
    new = []
    for i in range(cfg.num_layers):
        cache = None
        if caches is not None:
            cache = {"conv": caches["conv"][i], "ssm": caches["ssm"][i]}
        x, cache = _apply_mamba_block(cfg, _layer(params["layers"], i), x,
                                      cache=cache)
        new.append(cache)
    if caches is None:
        return x, None
    return x, {k: torch.stack([c[k] for c in new]) for k in ("conv", "ssm")}


def _mamba_cache(caches, *index):
    """One block's {"conv", "ssm"} cache of stacked caches (None: none)."""
    return None if caches is None else {k: caches[k][index]
                                        for k in ("conv", "ssm")}


def _stack_caches(new):
    """A list (or list of lists) of per-block caches -> stacked caches."""
    if isinstance(new[0], list):
        new = [_stack_caches(row) for row in new]
    return {k: torch.stack([c[k] for c in new]) for k in ("conv", "ssm")}


def _forward_hybrid(cfg, params, batch, caches, cache_index):
    """The hybrid trunk (``_forward_hybrid`` of the JAX package, its scan a
    Python loop); with caches, the new mamba and tail caches (prefill or
    one decode step) and the attention caches written in place."""
    x = _embed(cfg, params, batch)
    positions = batch.get("positions")
    segment_ids = batch.get("segment_ids")
    P, n_super, tail = hybrid_split(cfg)
    shared = params["shared_attn"]
    mcache = tcache = acache = None
    if caches is not None:
        mcache, tcache = caches["mamba"], caches["tail"]
    new_m = []
    for i in range(n_super):
        sup = _layer(params["mamba"], i)
        row = []
        for j in range(P):
            x, c = _apply_mamba_block(cfg, _layer(sup, j), x,
                                      cache=_mamba_cache(mcache, i, j))
            row.append(c)
        new_m.append(row)
        if caches is not None:
            acache = {k: caches["attn"][k][i] for k in ("k", "v")}  # views
        x, _ = _apply_dense_block(
            cfg, shared, x, window=cfg.sliding_window or 0,
            positions=positions, segment_ids=segment_ids, cache=acache,
            cache_index=cache_index)
    new_t = []
    for j in range(tail):
        x, c = _apply_mamba_block(cfg, _layer(params["mamba_tail"], j), x,
                                  cache=_mamba_cache(tcache, j))
        new_t.append(c)
    if caches is None:
        return x, None
    return x, {"mamba": _stack_caches(new_m), "attn": caches["attn"],
               "tail": _stack_caches(new_t) if tail else None}


def _forward_moe(cfg, params, batch, caches, cache_index, moe_groups):
    """The moe trunk (``_forward_moe`` of the JAX package, its scan a
    Python loop); with caches, the dense blocks' KV and the moe blocks'
    written in place and the new router tallies."""
    x = _embed(cfg, params, batch)
    positions = batch.get("positions")
    segment_ids = batch.get("segment_ids")
    P, n_super = moe_split(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    counts = []
    for i in range(n_super):
        sup = _layer(params["layers"], i)
        for j in range(P - 1):
            cache = None
            if caches is not None:
                cache = {k: caches["dense"][k][i, j] for k in ("k", "v")}
            x, _ = _apply_dense_block(
                cfg, _layer(sup["dense"], j), x, window=0,
                positions=positions, segment_ids=segment_ids, cache=cache,
                cache_index=cache_index)
        cache = None
        if caches is not None:
            cache = {k: v[i] for k, v in caches["moe"].items()}
        x, cache, aux_l = _apply_moe_block(
            cfg, sup["moe"], x, positions=positions, segment_ids=segment_ids,
            cache=cache, cache_index=cache_index, moe_groups=moe_groups)
        aux = aux + aux_l
        if cache is not None:
            counts.append(cache["router_counts"])
    if caches is None:
        return x, aux, None
    new = dict(caches)
    new["moe"] = dict(caches["moe"], router_counts=torch.stack(counts))
    return x, aux, new


def _encode(cfg, params, encoder_embeds):
    x = encoder_embeds
    for i in range(cfg.num_encoder_layers):
        x = _encoder_block(cfg, _layer(params["enc_layers"], i), x)
    return L.rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def _forward_audio(cfg, params, batch, caches, cache_index):
    """The encoder-decoder (``_forward_audio`` of the JAX package): the
    encoder on ``encoder_embeds`` when the batch carries them, else the
    cached encoder output; then the decoder.  With caches, the self-
    attention KV written in place and the encoder output in the new
    caches."""
    if "encoder_embeds" in batch:
        enc_out = _encode(cfg, params, _enc_input(params, batch))
    elif caches is not None and caches.get("enc_out") is not None:
        enc_out = caches["enc_out"]
    else:
        raise ValueError(f"{cfg.name}: the decoder needs the batch's "
                         f"encoder_embeds or a cache holding enc_out")
    x = _embed(cfg, params, batch)
    positions = batch.get("positions")
    segment_ids = batch.get("segment_ids")
    for i in range(cfg.num_layers):
        cache = None
        if caches is not None:
            cache = {k: caches["self"][k][i] for k in ("k", "v")}  # views
        x, _ = _apply_dec_block(
            cfg, _layer(params["dec_layers"], i), x, enc_out,
            positions=positions, segment_ids=segment_ids, cache=cache,
            cache_index=cache_index)
    if caches is None:
        return x, None
    return x, {"self": caches["self"], "enc_out": enc_out}


def apply(cfg: ModelConfig, params, batch, *, caches=None, cache_index=None,
          last_only: bool = False, moe_groups: int = 0):
    """Forward pass.  batch: tokens (B, S) and optional positions,
    segment_ids (B, S) (the ssm family reads neither), vision_embeds and
    (the audio family) encoder_embeds.
    Attention caches are written in place at ``cache_index``; ssm caches
    are not written, nor are the moe family's router tallies, and the new
    ones come back.  last_only=True projects only the final position to
    logits.  ``moe_groups``: the moe family's dispatch groups (0 = one per
    batch row).  Returns (logits, aux, caches); aux is the moe family's
    summed router loss (a tensor), 0.0 for the other families."""
    _require_ported(cfg)
    aux = 0.0
    if cfg.family == "ssm":
        x, caches = _forward_ssm(cfg, params, batch, caches)
    elif cfg.family == "hybrid":
        x, caches = _forward_hybrid(cfg, params, batch, caches, cache_index)
    elif cfg.family == "audio":
        x, caches = _forward_audio(cfg, params, batch, caches, cache_index)
    elif is_moe(cfg):
        x, aux, caches = _forward_moe(cfg, params, batch, caches,
                                      cache_index, moe_groups)
    else:
        x = _forward_dense(cfg, params, batch, caches, cache_index)
    if last_only:
        x = x[:, -1:]
    return _logits(cfg, params, x), aux, caches


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device="cuda", enc_len: int = 0):
    """Zeroed decode caches: dense {"k", "v"} of shape (L, B, max_len, KH,
    hd); ssm {"conv": (L, B, W-1, conv_dim) in ``dtype``, "ssm": (L, B, h,
    p, n) float32}, broadcast views of one layer's zeros (``apply`` never
    writes an ssm cache); hybrid {"mamba": ssm's at (n_super, P), "attn":
    dense's at (n_super,), "tail": ssm's at (tail,) or None}; moe
    {"moe": dense's at (n_super,) and "router_counts" (n_super, B, k, E)
    int32 zeros, "dense": dense's at (n_super, P-1) when P > 1}; audio
    {"self": dense's, "enc_out": (batch, enc_len, d) zeros, or None for
    ``enc_len`` 0}."""
    _require_ported(cfg)
    if cfg.family == "audio":
        enc_out = (torch.zeros((batch, enc_len, cfg.d_model), dtype=dtype,
                               device=device) if enc_len else None)
        return {"self": _attn_cache(cfg, (cfg.num_layers,), batch, max_len,
                                    dtype, device),
                "enc_out": enc_out}
    if is_moe(cfg):
        P, n_super = moe_split(cfg)
        moe = _attn_cache(cfg, (n_super,), batch, max_len, dtype, device)
        moe["router_counts"] = torch.zeros(
            (n_super, batch, cfg.experts_per_token, cfg.num_experts),
            dtype=torch.int32, device=device)
        caches = {"moe": moe}
        if P > 1:
            caches["dense"] = _attn_cache(cfg, (n_super, P - 1), batch,
                                          max_len, dtype, device)
        return caches
    if cfg.family in ("ssm", "hybrid"):
        base = ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
        mamba = lambda *pre: {k: v.expand(pre + v.shape)
                              for k, v in base.items()}
        if cfg.family == "ssm":
            return mamba(cfg.num_layers)
        P, n_super, tail = hybrid_split(cfg)
        return {"mamba": mamba(n_super, P),
                "attn": _attn_cache(cfg, (n_super,), batch, max_len, dtype,
                                    device),
                "tail": mamba(tail) if tail else None}
    return _attn_cache(cfg, (cfg.num_layers,), batch, max_len, dtype, device)


def _attn_cache(cfg, pre, batch, max_len, dtype, device):
    shape = pre + (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ===========================================================================
# training forward and loss
# ===========================================================================
def _identity(trees):
    return trees


def forward_ranks(cfg: ModelConfig, params_list, batches, *,
                  remat: bool = False, pxform=None, prefetch=None,
                  cp: int = 1, moe_groups: int = 0, ep: bool = False):
    """Final hidden states of several ranks' batches, run in lockstep layer
    by layer (no caches): the training forward, ``_forward_dense`` of the
    JAX package for each rank.  Returns (top-level trees, hidden states,
    aux losses), one of each per rank.

    ``cp`` > 1: the ranks are cp groups of ``cp`` adjacent ranks, each
    rank's batch one sequence shard of its group's rows (in the
    ``core.cp`` layout), and each layer's attention runs once per group
    (``layers.group_attention``, the ring) instead of once per rank.

    ``pxform(trees)`` maps the ranks' parameter subtrees (a list, one per
    rank) to the trees the layer computes with: the FSDP hook, as
    ``pxform`` in the JAX package, but over every rank at once so that a
    per-layer gather is one call for all ranks.  It sees the top-level
    leaves once, then each layer's slice inside the layer loop.
    ``remat=True`` recomputes each layer, hook included, in the backward
    pass (``jax.checkpoint`` around the scan body).

    ``prefetch`` (schedule='overlap', the ``prefetch`` branch of the JAX
    ``_forward_dense``): a dict of hooks, one per trunk group
    (``fsdp.trunk_groups``); the layer loop is ``core.odc.prefetch_scan``,
    and the trunk's hook materializes each layer's trees one iteration
    ahead in place of ``pxform``, which then sees the top-level leaves
    only.

    The ssm family runs each rank's mamba blocks in the same lockstep; it
    has no cp path: a recurrence split over a group's ranks would need its
    state passed between them (``require_cp``).

    The hybrid family steps through its super-layers (``_hybrid_ranks``):
    ``pxform`` sees the top-level leaves (``shared_attn`` among them,
    gathered once per forward for its n_super invocations) and each mamba
    block's slice; ``prefetch`` walks the super-layers, each issued whole,
    and the tail's blocks go through ``pxform``; ``remat`` recomputes
    each super-layer and each tail block.

    The moe family steps through its super-layers (``_moe_ranks``):
    ``pxform`` sees each dense block's and each moe block's slice, and
    ``prefetch`` walks the super-layers, each issued whole (the JAX
    ``pbody``).  ``moe_groups`` are its dispatch groups; ``ep``: weight-
    stationary expert parallelism, each rank's tree holding its E/n
    experts (not gathered) and the moe blocks exchanging dispatch buffers
    across the ranks (``moe.moe_apply_ep``) in place of running every
    expert on every rank.

    The audio family runs its two trunks in turn (``_audio_ranks``): the
    encoder's layers over every rank's ``encoder_embeds``, then the
    decoder's, each layer's slice through ``pxform``, or under
    ``prefetch`` two walks, ``enc_layers`` then ``dec_layers`` (the JAX
    package's two ``_prefetch_scan`` calls); ``remat`` recomputes each
    layer.  It has no cp path (``require_cp``)."""
    _require_ported(cfg)
    if cp > 1:
        require_cp(cfg)
    px = pxform or _identity
    trunk = fsdp.stacked_groups(params_list[0])
    tops = px([{k: v for k, v in p.items() if k not in trunk}
               for p in params_list])
    xs = [_embed(cfg, t, b) for t, b in zip(tops, batches)]
    if is_moe(cfg):
        xs, auxs = _moe_ranks(cfg, params_list, xs, batches, remat=remat,
                              px=px, prefetch=prefetch,
                              moe_groups=moe_groups, ep=ep)
        return tops, xs, auxs
    zeros = [0.0] * len(xs)
    if cfg.family == "audio":
        return tops, _audio_ranks(cfg, params_list, tops, xs, batches,
                                  remat=remat, px=px,
                                  prefetch=prefetch), zeros
    if cfg.family == "hybrid":
        return tops, _hybrid_ranks(cfg, params_list, tops, xs, batches,
                                   remat=remat, px=px,
                                   prefetch=prefetch), zeros

    def blocks(i, xs, full):
        if cfg.family == "ssm":
            return [_apply_mamba_block(cfg, lp, x, cache=None)[0]
                    for lp, x in zip(full, xs)]
        if cp > 1:
            return _apply_cp_blocks(cfg, full, xs, batches,
                                    window=layer_window(cfg, i), cp=cp)
        return [_apply_dense_block(
            cfg, lp, x, window=layer_window(cfg, i),
            positions=b.get("positions"), segment_ids=b.get("segment_ids"),
            cache=None, cache_index=None)[0]
            for lp, x, b in zip(full, xs, batches)]

    def layer_trees(i):
        return [_layer(p["layers"], i) for p in params_list]

    if prefetch is not None:
        return tops, prefetch_scan(blocks, xs, layer_trees, cfg.num_layers,
                                   prefetch["layers"], remat=remat), zeros

    def body(i, xs, trees):
        return blocks(i, xs, px(trees))

    return tops, _layer_loop(body, xs, layer_trees, cfg.num_layers,
                             remat), zeros


def _layer_loop(body, xs, layer_trees, num_layers, remat):
    """``body(i, xs, layer_trees(i))`` for every layer, each recomputed in
    the backward pass under ``remat``."""
    for i in range(num_layers):
        if remat:
            xs = checkpoint(body, i, xs, layer_trees(i), use_reentrant=False)
        else:
            xs = body(i, xs, layer_trees(i))
    return xs


def _hybrid_ranks(cfg, params_list, tops, xs, batches, *, remat, px,
                  prefetch):
    """The hybrid trunk of every rank in lockstep: per super-layer its P
    mamba blocks (each block's slice through ``px``, unless the super-layer
    comes materialized from ``prefetch``), then the shared block with the
    ranks' gathered ``shared_attn``; then the tail's blocks."""
    P, n_super, tail = hybrid_split(cfg)
    window = cfg.sliding_window or 0

    def mamba(xs, full):
        return [_apply_mamba_block(cfg, lp, x, cache=None)[0]
                for lp, x in zip(full, xs)]

    def super_layer(i, xs, sups, gather):
        for j in range(P):
            subs = [_layer(t, j) for t in sups]
            xs = mamba(xs, px(subs) if gather else subs)
        return [_apply_dense_block(
            cfg, t["shared_attn"], x, window=window,
            positions=b.get("positions"), segment_ids=b.get("segment_ids"),
            cache=None, cache_index=None)[0]
            for t, x, b in zip(tops, xs, batches)]

    def super_trees(i):
        return [_layer(p["mamba"], i) for p in params_list]

    if prefetch is not None:
        xs = prefetch_scan(lambda i, xs, full: super_layer(i, xs, full,
                                                           False),
                           xs, super_trees, n_super, prefetch["mamba"],
                           remat=remat)
    else:
        xs = _layer_loop(lambda i, xs, sups: super_layer(i, xs, sups, True),
                         xs, super_trees, n_super, remat)
    return _layer_loop(
        lambda j, xs, subs: mamba(xs, px(subs)), xs,
        lambda j: [_layer(p["mamba_tail"], j) for p in params_list], tail,
        remat)


def _audio_ranks(cfg, params_list, tops, xs, batches, *, remat, px,
                 prefetch):
    """The encoder-decoder of every rank in lockstep: the encoder's layers
    over each rank's frame embeddings and ``enc_final_norm``, then the
    decoder's layers over ``xs``, each rank's cross-attention reading its
    own encoder output."""
    def walk(group, blocks, carry, num_layers):
        def trees(i):
            return [_layer(p[group], i) for p in params_list]

        if prefetch is not None:
            return prefetch_scan(blocks, carry, trees, num_layers,
                                 prefetch[group], remat=remat)
        return _layer_loop(lambda i, c, t: blocks(i, c, px(t)), carry,
                           trees, num_layers, remat)

    encs = walk("enc_layers",
                lambda i, es, full: [_encoder_block(cfg, lp, e)
                                     for lp, e in zip(full, es)],
                [_enc_input(t, b) for t, b in zip(tops, batches)],
                cfg.num_encoder_layers)
    encs = [L.rms_norm(e, t["enc_final_norm"], cfg.norm_eps)
            for e, t in zip(encs, tops)]
    return walk("dec_layers",
                lambda i, xs, full: [_apply_dec_block(
                    cfg, lp, x, e, positions=b.get("positions"),
                    segment_ids=b.get("segment_ids"), cache=None,
                    cache_index=None)[0]
                    for lp, x, e, b in zip(full, xs, encs, batches)],
                xs, cfg.num_layers)


def _moe_blocks(cfg, lps, xs, batches, *, moe_groups, ep):
    """One moe block over every rank: per rank without ``ep``; with it,
    attention per rank and the experts through the exchange.  Returns
    (xs, auxs)."""
    if not ep:
        outs = [_apply_moe_block(
            cfg, lp, x, positions=b.get("positions"),
            segment_ids=b.get("segment_ids"), cache=None, cache_index=None,
            moe_groups=moe_groups) for lp, x, b in zip(lps, xs, batches)]
        return [o[0] for o in outs], [o[2] for o in outs]
    mids, hs = zip(*[_moe_attention(cfg, lp, x, positions=b.get("positions"),
                                    segment_ids=b.get("segment_ids"))
                     for lp, x, b in zip(lps, xs, batches)])
    ffns, auxs = moe_mod.moe_apply_ep(cfg, [lp["moe"] for lp in lps], hs)
    return ([x + _shared(cfg, lp, h, f)
             for lp, x, h, f in zip(lps, mids, hs, ffns)], auxs)


def _moe_ranks(cfg, params_list, xs, batches, *, remat, px, prefetch,
               moe_groups, ep):
    """The moe trunk of every rank in lockstep: per super-layer its P-1
    dense blocks, then its moe block, each block's slice through ``px``
    unless the super-layer comes materialized from ``prefetch``; the aux
    losses summed over the moe blocks.  The carry is (xs, auxs)."""
    P, n_super = moe_split(cfg)

    def super_layer(i, carry, sups, gather):
        xs, auxs = carry
        for j in range(P - 1):
            subs = [_layer(t["dense"], j) for t in sups]
            xs = [_apply_dense_block(
                cfg, lp, x, window=0, positions=b.get("positions"),
                segment_ids=b.get("segment_ids"), cache=None,
                cache_index=None)[0]
                for lp, x, b in zip(px(subs) if gather else subs, xs,
                                    batches)]
        moes = [t["moe"] for t in sups]
        xs, more = _moe_blocks(cfg, px(moes) if gather else moes, xs,
                               batches, moe_groups=moe_groups, ep=ep)
        return xs, [a + m for a, m in zip(auxs, more)]

    def super_trees(i):
        return [_layer(p["layers"], i) for p in params_list]

    carry = (xs, [torch.zeros((), dtype=torch.float32, device=x.device)
                  for x in xs])
    if prefetch is not None:
        return prefetch_scan(
            lambda i, c, full: super_layer(i, c, full, False), carry,
            super_trees, n_super, prefetch["layers"], remat=remat)
    return _layer_loop(lambda i, c, sups: super_layer(i, c, sups, True),
                       carry, super_trees, n_super, remat)


def _loss_from_hidden(cfg, top, x, batch, reduction, aux=0.0):
    logits = _logits(cfg, top, x).float()
    targets = batch["targets"].long()
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=logits.device)
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = (logz - tgt) * mask
    tokens = mask.abs().sum()
    if reduction == "sum":
        nll_sum = nll.sum()
        total = nll_sum + aux * torch.clamp(tokens, min=1.0)
        return total, {"ce_sum": nll_sum, "aux": aux, "tokens": tokens}
    ce = nll.sum() / torch.clamp(tokens, min=1.0)
    return ce + aux, {"ce": ce, "aux": aux, "tokens": tokens}


def loss_ranks(cfg: ModelConfig, params_list, batches, *,
               remat: bool = False, pxform=None, prefetch=None,
               reduction: str = "mean", cp: int = 1, moe_groups: int = 0,
               ep: bool = False):
    """``loss`` of several ranks' batches in one lockstep forward (see
    ``forward_ranks``); returns one (loss, metrics) per rank."""
    tops, xs, auxs = forward_ranks(cfg, params_list, batches, remat=remat,
                                   pxform=pxform, prefetch=prefetch, cp=cp,
                                   moe_groups=moe_groups, ep=ep)
    return [_loss_from_hidden(cfg, t, x, b, reduction, a)
            for t, x, b, a in zip(tops, xs, batches, auxs)]


def loss(cfg: ModelConfig, params, batch, *, remat: bool = False,
         reduction: str = "mean", moe_groups: int = 0):
    """Weighted token cross-entropy (weights = ``loss_mask``; signed
    weights carry advantages), ``repro.models.transformer.loss``.

    reduction='sum' returns the un-normalized nll sum, which the FSDP
    engines accumulate across microbatches before normalizing by the
    global token count.  Returns (loss, metrics) with metrics["tokens"] =
    sum |loss_mask|.  The router aux loss is added as the reference adds
    it: ``nll_sum + aux * max(tokens, 1)`` for 'sum', ``ce + aux`` for
    'mean', with ``aux`` in the metrics (0.0 for every family but moe)."""
    return loss_ranks(cfg, [params], [batch], remat=remat,
                      reduction=reduction, moe_groups=moe_groups)[0]
