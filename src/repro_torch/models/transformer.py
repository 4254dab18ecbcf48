"""Model assembly, dense and ssm families: the PyTorch counterpart of the
dense and ssm paths of ``repro.models.transformer``.

    init_params(cfg, gen, dtype)                   -> params dict
    apply(cfg, params, batch, ...)                 -> (logits, aux, caches)
    init_cache(cfg, batch, max_len, dtype, device) -> decode caches dict
    loss(cfg, params, batch, ...)                  -> (loss, metrics)
    loss_ranks(cfg, params_list, batches, ...)     -> [(loss, metrics)]

The params dict has the JAX tree's key names, with the per-layer leaves
stacked on a leading ``(L, ...)`` axis, so ``bridge.params_from_numpy``
carries a JAX tree over as it is.  The layer trunk is a Python loop over
that axis; each layer gets its sliding window as a Python int, which is
what the attention kernel needs.

The ssm family (mamba2) stacks ``{"norm", "mamba"}`` blocks under
``layers``; its caches are ``{"conv": (L, B, W-1, conv_dim), "ssm": (L, B,
h, p, n)}``, and ``apply`` returns new caches (the ones passed in are not
written).  As in the reference, the ssm forward reads no positions and no
segment ids: the conv and the scan run across packed samples.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.odc import prefetch_scan
from repro_torch.core.ranks import cp_groups
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig


def _require_ported(cfg: ModelConfig):
    if cfg.num_experts or cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch "
            f"yet (ROADMAP.md, queue 1 item 2); the port runs the dense and "
            f"ssm families")


def require_cp(cfg: ModelConfig):
    """Refuse context parallelism for a family that has no cp path."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: context parallelism of the {cfg.family} family is "
            f"not ported (ROADMAP.md, queue 1 item 5): a scan split over the "
            f"cp ranks needs its state passed between them")


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


def _mamba_block_params(gen, cfg, dtype, prefix_shape=()):
    return {
        "norm": torch.zeros(prefix_shape + (cfg.d_model,), dtype=dtype,
                            device=gen.device),
        "mamba": ssm_mod.mamba2_params(gen, cfg, dtype, prefix_shape),
    }


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
    block = _mamba_block_params if cfg.family == "ssm" \
        else _dense_block_params
    params["layers"] = block(gen, cfg, dtype, (cfg.num_layers,))
    return params


def param_shapes(cfg: ModelConfig):
    """The tree ``init_params`` builds, as meta tensors (shapes only)."""
    _require_ported(cfg)
    meta = lambda *shape: torch.empty(shape, device="meta")
    params = {"embed": meta(cfg.vocab_size, cfg.d_model)}
    if not cfg.tie_embeddings:
        params["lm_head"] = meta(cfg.d_model, cfg.vocab_size)
    params["final_norm"] = meta(cfg.d_model)
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    if cfg.family == "ssm":
        di, nh = cfg.ssm_d_inner, cfg.ssm_nheads
        gn = cfg.ssm_ngroups * cfg.ssm_state_size
        mamba = {"in_proj": meta(L, d, 2 * di + 2 * gn + nh),
                 "conv_w": meta(L, cfg.ssm_conv_width, di + 2 * gn),
                 "conv_b": meta(L, di + 2 * gn), "dt_bias": meta(L, nh),
                 "A_log": meta(L, nh), "D": meta(L, nh),
                 "gate_norm": meta(L, di), "out_proj": meta(L, di, d)}
        params["layers"] = {"norm": meta(L, d), "mamba": mamba}
        return params
    qd, kvd, hd = cfg.q_dim, cfg.kv_dim, cfg.resolved_head_dim
    attn = {"wq": meta(L, d, qd), "wk": meta(L, d, kvd),
            "wv": meta(L, d, kvd), "wo": meta(L, qd, d)}
    if cfg.qk_norm:
        attn["q_norm"] = meta(L, hd)
        attn["k_norm"] = meta(L, hd)
    mlp = {"w_up": meta(L, d, f), "w_down": meta(L, f, d)}
    if cfg.activation in ("swiglu", "geglu"):
        mlp["w_gate"] = meta(L, d, f)
    params["layers"] = {"attn_norm": meta(L, d), "attn": attn,
                        "mlp_norm": meta(L, d), "mlp": mlp}
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
    return params["embed"][batch["tokens"]]


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


def apply(cfg: ModelConfig, params, batch, *, caches=None, cache_index=None,
          last_only: bool = False):
    """Forward pass.  batch: tokens (B, S) and optional positions,
    segment_ids (B, S) (the ssm family reads neither).  Dense caches are
    written in place at ``cache_index``; ssm caches are not written, and
    the new ones come back.  last_only=True projects only the final
    position to logits.  Returns (logits, aux, caches); aux is 0.0 for
    both families."""
    _require_ported(cfg)
    if cfg.family == "ssm":
        x, caches = _forward_ssm(cfg, params, batch, caches)
    else:
        x = _forward_dense(cfg, params, batch, caches, cache_index)
    if last_only:
        x = x[:, -1:]
    return _logits(cfg, params, x), 0.0, caches


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device="cuda"):
    """Zeroed decode caches: dense {"k", "v"} of shape (L, B, max_len, KH,
    hd); ssm {"conv": (L, B, W-1, conv_dim) in ``dtype``, "ssm": (L, B, h,
    p, n) float32}, broadcast views of one layer's zeros (``apply`` never
    writes an ssm cache)."""
    _require_ported(cfg)
    if cfg.family == "ssm":
        base = ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
        return {k: v.expand((cfg.num_layers,) + v.shape)
                for k, v in base.items()}
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ===========================================================================
# training forward and loss
# ===========================================================================
def _identity(trees):
    return trees


def forward_ranks(cfg: ModelConfig, params_list, batches, *,
                  remat: bool = False, pxform=None, prefetch=None,
                  cp: int = 1):
    """Final hidden states of several ranks' batches, run in lockstep layer
    by layer (no caches): the training forward, ``_forward_dense`` of the
    JAX package for each rank.

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
    ``_forward_dense``): the layer loop is ``core.odc.prefetch_scan``, and
    the hook materializes each layer's trees one iteration ahead in place
    of ``pxform``, which then sees the top-level leaves only.

    The ssm family runs each rank's mamba blocks in the same lockstep; it
    has no cp path: a recurrence split over a group's ranks would need its
    state passed between them (``require_cp``)."""
    _require_ported(cfg)
    if cp > 1:
        require_cp(cfg)
    px = pxform or _identity
    tops = px([{k: v for k, v in p.items() if k != "layers"}
               for p in params_list])
    xs = [_embed(cfg, t, b) for t, b in zip(tops, batches)]

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
                                   prefetch, remat=remat)

    def body(i, xs, trees):
        return blocks(i, xs, px(trees))

    for i in range(cfg.num_layers):
        if remat:
            xs = checkpoint(body, i, xs, layer_trees(i), use_reentrant=False)
        else:
            xs = body(i, xs, layer_trees(i))
    return tops, xs


def _loss_from_hidden(cfg, top, x, batch, reduction):
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
        total = nll.sum()
        return total, {"ce_sum": total, "aux": 0.0, "tokens": tokens}
    ce = nll.sum() / torch.clamp(tokens, min=1.0)
    return ce, {"ce": ce, "aux": 0.0, "tokens": tokens}


def loss_ranks(cfg: ModelConfig, params_list, batches, *,
               remat: bool = False, pxform=None, prefetch=None,
               reduction: str = "mean", cp: int = 1):
    """``loss`` of several ranks' batches in one lockstep forward (see
    ``forward_ranks``); returns one (loss, metrics) per rank."""
    tops, xs = forward_ranks(cfg, params_list, batches, remat=remat,
                             pxform=pxform, prefetch=prefetch, cp=cp)
    return [_loss_from_hidden(cfg, t, x, b, reduction)
            for t, x, b in zip(tops, xs, batches)]


def loss(cfg: ModelConfig, params, batch, *, remat: bool = False,
         reduction: str = "mean"):
    """Weighted token cross-entropy (weights = ``loss_mask``; signed
    weights carry advantages), ``repro.models.transformer.loss``.

    reduction='sum' returns the un-normalized nll sum, which the FSDP
    engines accumulate across microbatches before normalizing by the
    global token count.  Returns (loss, metrics) with metrics["tokens"] =
    sum |loss_mask|.  The dense family has no auxiliary loss."""
    return loss_ranks(cfg, [params], [batch], remat=remat,
                      reduction=reduction)[0]
