"""Model assembly, dense family: the PyTorch counterpart of the dense path
of ``repro.models.transformer``.

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
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def _require_dense(cfg: ModelConfig):
    if cfg.family != "dense" or cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch "
            f"yet (ROADMAP.md, queue 1 item 7); this slice runs the dense "
            f"family only")


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


def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype=torch.float32):
    """Random weights drawn from ``gen``, on ``gen``'s device."""
    _require_dense(cfg)
    params = {"embed": L.embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                    dtype)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                         dtype)
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                       device=gen.device)
    params["layers"] = _dense_block_params(gen, cfg, dtype,
                                           (cfg.num_layers,))
    return params


def param_shapes(cfg: ModelConfig):
    """The tree ``init_params`` builds, as meta tensors (shapes only)."""
    _require_dense(cfg)
    meta = lambda *shape: torch.empty(shape, device="meta")
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    qd, kvd, hd = cfg.q_dim, cfg.kv_dim, cfg.resolved_head_dim
    attn = {"wq": meta(L, d, qd), "wk": meta(L, d, kvd),
            "wv": meta(L, d, kvd), "wo": meta(L, qd, d)}
    if cfg.qk_norm:
        attn["q_norm"] = meta(L, hd)
        attn["k_norm"] = meta(L, hd)
    mlp = {"w_up": meta(L, d, f), "w_down": meta(L, f, d)}
    if cfg.activation in ("swiglu", "geglu"):
        mlp["w_gate"] = meta(L, d, f)
    params = {"embed": meta(cfg.vocab_size, d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = meta(d, cfg.vocab_size)
    params["final_norm"] = meta(d)
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


def _apply_dense_block(cfg, lp, x, *, window, positions, segment_ids, cache,
                       cache_index):
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    a, cache = L.attn_apply(cfg, lp["attn"], h, window=window,
                            positions=positions, segment_ids=segment_ids,
                            cache=cache, cache_index=cache_index)
    x = x + a
    h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + L.mlp_apply(cfg, lp["mlp"], h), cache


def _logits(cfg, params, x):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    logits = x @ head
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


def apply(cfg: ModelConfig, params, batch, *, caches=None, cache_index=None,
          last_only: bool = False):
    """Forward pass.  batch: tokens (B, S) and optional positions,
    segment_ids (B, S).  caches are written in place at ``cache_index``.
    last_only=True projects only the final position to logits.  Returns
    (logits, aux, caches); aux is 0.0 for the dense family."""
    _require_dense(cfg)
    x = _forward_dense(cfg, params, batch, caches, cache_index)
    if last_only:
        x = x[:, -1:]
    return _logits(cfg, params, x), 0.0, caches


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device="cuda"):
    """Zeroed KV caches: {"k", "v"} of shape (L, B, max_len, KH, hd)."""
    _require_dense(cfg)
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
                  remat: bool = False, pxform=None):
    """Final hidden states of several ranks' batches, run in lockstep layer
    by layer (no caches): the training forward, ``_forward_dense`` of the
    JAX package for each rank.

    ``pxform(trees)`` maps the ranks' parameter subtrees (a list, one per
    rank) to the trees the layer computes with: the FSDP hook, as
    ``pxform`` in the JAX package, but over every rank at once so that a
    per-layer gather is one call for all ranks.  It sees the top-level
    leaves once, then each layer's slice inside the layer loop.
    ``remat=True`` recomputes each layer, hook included, in the backward
    pass (``jax.checkpoint`` around the scan body)."""
    _require_dense(cfg)
    px = pxform or _identity
    tops = px([{k: v for k, v in p.items() if k != "layers"}
               for p in params_list])
    xs = [_embed(cfg, t, b) for t, b in zip(tops, batches)]

    def body(i, xs, layer_trees):
        full = px(layer_trees)
        return [_apply_dense_block(
            cfg, lp, x, window=layer_window(cfg, i),
            positions=b.get("positions"), segment_ids=b.get("segment_ids"),
            cache=None, cache_index=None)[0]
            for lp, x, b in zip(full, xs, batches)]

    for i in range(cfg.num_layers):
        layer_trees = [_layer(p["layers"], i) for p in params_list]
        if remat:
            xs = checkpoint(body, i, xs, layer_trees, use_reentrant=False)
        else:
            xs = body(i, xs, layer_trees)
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
               remat: bool = False, pxform=None, reduction: str = "mean"):
    """``loss`` of several ranks' batches in one lockstep forward (see
    ``forward_ranks``); returns one (loss, metrics) per rank."""
    tops, xs = forward_ranks(cfg, params_list, batches, remat=remat,
                             pxform=pxform)
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
