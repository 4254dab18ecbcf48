"""Serve steps (prefill / decode) on one device: the single-card
counterparts of ``repro.core.gspmd``'s ``make_prefill_step``,
``make_decode_step`` and ``make_continuous_decode_step``.  One card needs
no mesh and no activation sharder; each step runs under
``torch.no_grad``, writes the KV cache in place and returns the cache to
carry on with (the ssm caches and the moe family's router tallies are
new tensors).
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig):
    """prefill(params, batch, cache) -> (last_logits, cache)."""

    @torch.no_grad()
    def prefill(params, batch, cache):
        logits, _, cache = T.apply(cfg, params, batch, caches=cache,
                                   cache_index=0, last_only=True)
        return logits, cache

    return prefill


def make_decode_step(cfg: ModelConfig):
    """decode(params, cache, tokens, index) -> (logits, cache).  tokens:
    (B, 1); index: int position of the new token in every row."""

    @torch.no_grad()
    def decode(params, cache, tokens, index: int):
        B = tokens.shape[0]
        positions = torch.full((B, 1), index, dtype=torch.int32,
                               device=tokens.device)
        logits, _, cache = T.apply(
            cfg, params, {"tokens": tokens, "positions": positions},
            caches=cache, cache_index=int(index), last_only=True)
        return logits, cache

    return decode


def make_continuous_decode_step(cfg: ModelConfig):
    """decode(params, cache, tokens, index) -> (logits, cache).  tokens:
    (B, 1); index: (B,) int32 tensor, row b's new token is written at
    ``index[b]`` (continuous batching)."""

    @torch.no_grad()
    def decode(params, cache, tokens, index):
        index = index.to(torch.int32)
        logits, _, cache = T.apply(
            cfg, params, {"tokens": tokens, "positions": index[:, None]},
            caches=cache, cache_index=index, last_only=True)
        return logits, cache

    return decode
