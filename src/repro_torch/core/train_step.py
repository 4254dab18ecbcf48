"""The FSDP train step over the ranks of a ``RankGroup``: the data-axis
path of ``repro.core.gspmd.make_train_step``.

One step: per rank, the schedule's gradient loop over its microbatches
(``backend.build_schedule_grad``); the loss and token sums over the ranks;
every gradient shard divided by the global token count; then AdamW on each
rank's shards with the global gradient norm (``_grad_minibatch`` and
``step`` of the JAX engine).  As with the JAX engine's ``remat=True``,
each layer is recomputed in the backward pass.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import backend as B
from repro_torch.core import fsdp, odc
from repro_torch.core.ranks import RankGroup
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm, tree_map)

# batch leaves read by the model, and the integer ones that index
_BATCH_KEYS = ("tokens", "targets", "positions", "segment_ids", "loss_mask")
_INDEX_KEYS = ("tokens", "targets")


def _global_norm(grads: Sequence[dict], dims) -> torch.Tensor:
    """The norm of the whole gradient tree from its shards: every sharded
    leaf's shards count once each, a replicated leaf once."""
    leaves = []
    for path in fsdp.tree_paths(dims):
        parts = [fsdp.get(g, path) for g in grads]
        leaves += parts[:1] if fsdp.get(dims, path) is None else parts
    return global_norm(leaves)


@dataclasses.dataclass
class Trainer:
    """The train step of one configuration; ``step`` runs it."""

    cfg: ModelConfig
    ranks: RankGroup
    comm: str = "odc"
    schedule: str = "minibatch"
    opt_cfg: AdamWConfig = AdamWConfig()
    lr_schedule: Optional[Callable] = None
    device_profile: object = None

    def __post_init__(self):
        self.backend, self.schedule = B.resolve(self.comm, self.schedule)
        n = self.ranks.n
        self.order = odc.ring_order(n, self.device_profile)
        shapes = T.param_shapes(self.cfg)
        self.dims = fsdp.leaf_dims(shapes, n)

        def loss_ranks(params_list, batches, pxform):
            outs = T.loss_ranks(self.cfg, params_list, batches,
                                remat=True, pxform=pxform,
                                reduction="sum")
            return [(l, m["tokens"]) for l, m in outs]

        self._grad_core = B.build_schedule_grad(
            self.schedule, loss_ranks=loss_ranks, backend=self.backend,
            dims=self.dims, order=self.order)

    # -- state --------------------------------------------------------------
    def init_state(self, params):
        """(shards, optimizer states) of a full parameter tree."""
        shards = fsdp.shard_params(params, self.ranks)
        return shards, [adamw_init(s) for s in shards]

    def unshard(self, shards, device="cpu"):
        return fsdp.unshard_params(shards, self.dims, device)

    # -- batches ------------------------------------------------------------
    def split_batch(self, batch) -> List[List[dict]]:
        """The (M, W, S) global batch (numpy, from ``build_minibatch``) ->
        per rank, its M microbatches of (1, S) tensors on its device."""
        M, W = batch["tokens"].shape[:2]
        if W != self.ranks.n:
            raise ValueError(f"batch has {W} rank rows, the step has "
                             f"{self.ranks.n} ranks")
        out = []
        for r, dev in enumerate(self.ranks.devices):
            mbs = []
            for j in range(M):
                mb = {}
                for k in _BATCH_KEYS:
                    if k not in batch:
                        continue
                    x = torch.from_numpy(np.ascontiguousarray(
                        batch[k][j, r:r + 1]))
                    if k in _INDEX_KEYS:
                        x = x.long()
                    mb[k] = x.to(dev)
                mbs.append(mb)
            out.append(mbs)
        return out

    # -- the step -----------------------------------------------------------
    def grads(self, shards, batch, counts: Optional[Sequence[int]] = None):
        """Per-rank gradient shards of the mean loss over every rank's
        tokens, and the step's metrics (``_grad_minibatch``).  ``counts``
        gives each rank's number of real microbatches (the plan's); the
        minibatch schedule skips the empty padding after them, which adds
        exactly nothing."""
        mbs = self.split_batch(batch)
        M = len(mbs[0])
        counts = [M] * self.ranks.n if counts is None else list(counts)
        lsums, toks, grads = self._grad_core(shards, mbs, counts)
        dev = lsums[0].device
        lsum = lsums[0]
        tok = toks[0]
        for l, t in zip(lsums[1:], toks[1:]):
            lsum = lsum + l.to(dev)
            tok = tok + t.to(dev)
        denom = torch.clamp(tok, min=1.0)
        for g in grads:  # in place: the shards are fresh, not the storage
            tree_map(lambda x: x.div_(denom.to(x.device)), g)
        return grads, {"loss": lsum / denom, "tokens": tok}

    def step(self, shards, opt_states, batch, counts=None):
        """One train step: returns (shards, optimizer states, metrics);
        metrics hold the loss, the token count and ``grad_norm``, the
        gradient's global norm before clipping."""
        grads, metrics = self.grads(shards, batch, counts)
        gn = _global_norm(grads, self.dims)
        scale = (self.lr_schedule(opt_states[0]["step"])
                 if self.lr_schedule else 1.0)
        new_shards, new_opt = [], []
        for s, g, o in zip(shards, grads, opt_states):
            p, st = adamw_update(self.opt_cfg, s, g, o, lr_scale=scale,
                                 grad_norm=gn.to(fsdp.get(
                                     s, ("final_norm",)).device))
            new_shards.append(p)
            new_opt.append(st)
        metrics["grad_norm"] = gn
        return new_shards, new_opt, metrics

