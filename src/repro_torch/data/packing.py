"""Sequence packing: samples -> fixed-size token buffers with segment ids.

Packing concatenates multiple samples into one (buffer_len,) sequence;
``segment_ids`` keep attention from crossing sample boundaries
(cross-contamination-free packing, Krell et al. 2021) and ``positions``
restart per sample (RoPE correctness).  Loss masks cover real tokens only.

``build_minibatch`` is the plan-level assembly step shared by every
driver (``launch.train``, ``launch.posttrain``, the GRPO example): a
balance ``Plan`` + per-sample token arrays -> the (M, W, S) global
microbatch stack, with optional per-sample advantage weights folded into
``loss_mask`` (signed weights — the loss kernel treats |mask| as token
weight, sign as advantage direction).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def pack_sequences(sample_tokens: Sequence[np.ndarray], buffer_len: int,
                   pad_id: int = 0) -> Dict[str, np.ndarray]:
    """Pack samples (each a 1-D token array) into ONE buffer row.

    Returns tokens/targets/positions/segment_ids/loss_mask of shape
    (buffer_len,).  Targets are next-token shifted within each segment;
    the final position of each segment is masked out.  Padding has
    segment_id = -1.
    """
    tokens = np.full((buffer_len,), pad_id, np.int32)
    targets = np.full((buffer_len,), pad_id, np.int32)
    positions = np.zeros((buffer_len,), np.int32)
    segment_ids = np.full((buffer_len,), -1, np.int32)
    loss_mask = np.zeros((buffer_len,), np.float32)
    cur = 0
    for seg, toks in enumerate(sample_tokens):
        s = len(toks)
        assert cur + s <= buffer_len, "samples exceed the buffer"
        tokens[cur: cur + s] = toks
        targets[cur: cur + s - 1] = toks[1:]
        positions[cur: cur + s] = np.arange(s)
        segment_ids[cur: cur + s] = seg
        loss_mask[cur: cur + s - 1] = 1.0
        cur += s
    return {
        "tokens": tokens, "targets": targets, "positions": positions,
        "segment_ids": segment_ids, "loss_mask": loss_mask,
    }


def pack_plan_to_batches(plan_microbatches: Sequence[Sequence[int]],
                         sample_tokens: Sequence[np.ndarray],
                         buffer_len: int, pad_id: int = 0):
    """One device's microbatch index lists -> stacked (M, 1, buffer_len)
    arrays (each microbatch is one packed buffer row)."""
    rows = [pack_sequences([sample_tokens[i] for i in mb], buffer_len, pad_id)
            for mb in plan_microbatches]
    if not rows:
        rows = [pack_sequences([], buffer_len, pad_id)]
    return {
        k: np.stack([r[k] for r in rows])[:, None, :]
        for k in rows[0]
    }


def build_minibatch(plan, sample_tokens: Sequence[np.ndarray],
                    buffer_len: int, *,
                    advantages: Optional[Sequence[float]] = None,
                    extras=None, pad_id: int = 0):
    """Assemble the (M, W, S) global microbatch stack from a balance plan;
    devices with fewer microbatches are padded with empty rows.

    advantages  per-GLOBAL-sample weights (e.g. Dr.GRPO group-mean-zero
                advantages): each sample's loss-mask segment is scaled by
                its (signed) advantage.
    extras      {name: fn(M, world) -> array} appended to the batch (stub
                modality embeddings in the drivers).

    Context parallelism: for a cp plan (``plan.cp > 1``, from
    ``lb_token``) each batch row is one ring *group* — its buffer is
    ``cp * buffer_len`` tokens (so every cp rank's sequence shard is
    ``buffer_len``, the same per-device memory budget), and the packed
    sequence dim is pre-interleaved with
    ``repro.core.cp.interleave_indices`` so the engine's contiguous
    shard_map split hands each rank its head+tail chunk pair.  The port
    has no context parallelism yet, so a cp plan raises.

    Returns numpy arrays; the train step moves each rank's rows to its
    device.
    """
    cp = getattr(plan, "cp", 1)
    if cp > 1:
        raise NotImplementedError(
            "context-parallel plans (cp > 1) are not yet ported to "
            "repro_torch")
    row_len = buffer_len
    M = max(plan.max_microbatches, 1)
    world = plan.world_size
    per_dev = []
    for dev in plan.assignments:
        mbs = list(dev) + [[] for _ in range(M - len(dev))]
        d = pack_plan_to_batches(mbs, sample_tokens, row_len, pad_id)
        if advantages is not None:
            # rescale each sample's loss-mask segment by its advantage
            for m, mb in enumerate(mbs):
                for seg, idx in enumerate(mb):
                    row = d["segment_ids"][m, 0]
                    d["loss_mask"][m, 0] = np.where(
                        row == seg, d["loss_mask"][m, 0] * advantages[idx],
                        d["loss_mask"][m, 0])
        per_dev.append(d)
    batch = {
        k: np.concatenate([d[k] for d in per_dev], axis=1)
        for k in per_dev[0]
    }
    if extras:  # e.g. stub modality embeddings
        for k, v in extras.items():
            batch[k] = v(M, world)
    return batch
