"""The FSDP train step over the ranks of a ``RankGroup``: the data-axis
path of ``repro.core.gspmd.make_train_step``.

One step: per rank, the schedule's gradient loop over its microbatches
(``backend.build_schedule_grad``); the loss and token sums over the ranks;
every gradient shard divided by the global token count; then AdamW on each
rank's shards with the global gradient norm (``_grad_minibatch`` and
``step`` of the JAX engine).  As with the JAX engine's ``remat=True``,
each layer is recomputed in the backward pass.

The overlap schedule's materialize-ahead hook (``gspmd.pxform_overlap``
and the ``prefetch`` it hands to ``build_schedule_grad``): with a ring
backend the Trainer owns a ``core.overlap.ChainedTrunks`` (per trunk,
the audio family's two included: its packing, the side stream and the
per-layer signals, kept across steps), whose per-round
``ChainedPrefetch`` hooks materialize each layer from the chained
gather; with ``collective`` the hook gathers layer l+1 through
``param_gather`` one iteration ahead.

Context parallelism (``comm='cp'``, ``cp`` > 1): the ranks form groups
of cp adjacent ranks (``core.ranks.cp_groups``); each group shares its
batch rows, every rank holding a contiguous 1/cp slice of their
(interleaved) sequence dim, and attention runs once per group through
``core.cp``'s ring.  Parameters stay sharded over all ranks, as under
flat ODC.

The two-tier backends (``comm='hier'``, ``'pipe'``, ``'pipe-int8'``): the
ranks form ``inter`` groups (nodes, or pipeline stages) of n / inter
ranks (``core.ranks.Tiers``), the norms shard over a group's ranks only
(``fsdp.IntraDim``), and the backend moves every other leaf over both
tiers; under ``pipe`` the ``1f1b`` schedule issues each rank's
microbatches in the order of an ``inter``-stage pipeline.

The audio family (``collective``, ``odc``, ``odc-overlap``): each
microbatch row carries its frame embeddings (``encoder_embeds``, split by
rows); ``backend.resolve`` refuses cp and the two-tier backends.

The moe family (``collective``, ``odc``, ``odc-overlap``): ``moe_groups``
and ``moe_ep`` are ``GSPMDConfig.moe_groups`` and ``moe_ep``.  Every rank
runs every microbatch of the step, the padding ones included: a padding
microbatch has no tokens but its router loss counts (``aux * max(tokens,
1)``), as in the JAX engine, which runs the padded microbatches.  With
``moe_ep='data'`` and E divisible by the ranks, the experts are
weight-stationary (``fsdp.Stationary``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import backend as B
from repro_torch.core import fsdp, overlap
from repro_torch.core.ranks import RankGroup, Tiers, cp_groups
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm, tree_map)

# batch leaves read by the model (each with a sequence dim), and the
# integer ones that index
_BATCH_KEYS = ("tokens", "targets", "positions", "segment_ids", "loss_mask")
_INDEX_KEYS = ("tokens", "targets")
# batch leaves split by rows only (the stub frontend's embeddings)
_ROW_KEYS = ("vision_embeds", "encoder_embeds")


def _global_norm(grads: Sequence[dict], dims) -> torch.Tensor:
    """The norm of the whole gradient tree from its shards: every distinct
    piece of a leaf counts once (all shards of a sharded leaf, a
    stationary expert bank's among them, the first group's of an
    ``IntraDim`` leaf, one copy of a replicated leaf)."""
    leaves = []
    for path in fsdp.tree_paths(dims):
        parts = [fsdp.get(g, path) for g in grads]
        leaves += parts[:fsdp.pieces(fsdp.get(dims, path), len(parts))]
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
    #: the cp group size (``comm='cp'`` only)
    cp: int = 1
    #: the two-tier backends: nodes (``hier``) or pipeline stages
    #: (``pipe``, ``pipe-int8``), each of ranks.n / inter ranks
    inter: int = 2
    #: schedule '1f1b': the interleaved (halved-warmup) order
    pipe_interleave: bool = False
    #: the moe family's dispatch groups (0 = one per batch row)
    moe_groups: int = 0
    #: 'none' (the expert banks gathered as any leaf) or 'data'
    #: (weight-stationary expert parallelism over the ranks, when the
    #: rank count divides the experts; else as 'none')
    moe_ep: str = "none"

    def __post_init__(self):
        n = self.ranks.n
        if self.moe_ep not in ("none", "data"):
            raise ValueError(f"moe_ep must be 'none' or 'data', not "
                             f"{self.moe_ep!r}")
        E = self.cfg.num_experts
        self.moe = T.is_moe(self.cfg)
        self.ep = (self.moe and self.moe_ep == "data" and E % n == 0
                   and E >= n)
        self.backend, self.schedule = B.resolve(
            self.comm, self.schedule, moe=self.moe, ep=self.ep,
            audio=self.cfg.family == "audio")
        if self.cp != 1 and self.backend is not B.CP:
            raise ValueError(f"cp={self.cp} needs comm 'cp', not "
                             f"{self.backend.name!r}")
        if self.backend is B.CP:
            T.require_cp(self.cfg)
        self.groups = cp_groups(n, self.cp)
        self.tiers = None
        if self.backend.two_tier:
            self.tiers = Tiers.split(n, self.inter)
            self.backend = self.backend.on(self.tiers)
        self.order = self.backend.ring_order(n, self.device_profile)
        shapes = T.param_shapes(self.cfg)
        self.dims = fsdp.leaf_dims(
            shapes, n, self.tiers.intra if self.tiers else None, self.ep)
        self.chain = None
        if self.schedule == "overlap" and self.backend.chained:
            self.chain = overlap.ChainedTrunks(shapes, self.dims,
                                               self.ranks.devices, self.order)

        def loss_ranks(params_list, batches, pxform, prefetch):
            outs = T.loss_ranks(self.cfg, params_list, batches,
                                remat=True, pxform=pxform,
                                prefetch=prefetch, reduction="sum",
                                cp=self.cp, moe_groups=self.moe_groups,
                                ep=self.ep)
            return [(l, m["tokens"]) for l, m in outs]

        self._grad_core = B.build_schedule_grad(
            self.schedule, loss_ranks=loss_ranks, backend=self.backend,
            dims=self.dims, order=self.order, chain=self.chain, cp=self.cp,
            pipe_stages=self.inter if self.backend.implied_schedule == "1f1b"
            else 1, pipe_interleave=self.pipe_interleave,
            lockstep=self.ep)

    # -- state --------------------------------------------------------------
    def init_state(self, params):
        """(shards, optimizer states) of a full parameter tree."""
        shards = fsdp.shard_params(params, self.ranks, self.dims)
        return shards, [adamw_init(s) for s in shards]

    def unshard(self, shards, device="cpu"):
        return fsdp.unshard_params(shards, self.dims, device)

    def state_tree(self, shards, opt_states, device="cpu"):
        """The train state as one unsharded tree, the JAX driver's
        checkpoint layout: ``{"params": ..., "opt": {"m", "v", "step"}}``."""
        return {"params": self.unshard(shards, device),
                "opt": {"m": self.unshard([o["m"] for o in opt_states],
                                          device),
                        "v": self.unshard([o["v"] for o in opt_states],
                                          device),
                        "step": opt_states[0]["step"].to(device)}}

    def state_like(self):
        """The keys of ``state_tree`` (meta tensors as leaves)."""
        shapes = T.param_shapes(self.cfg)
        return {"params": shapes, "opt": {"m": shapes, "v": shapes,
                                          "step": torch.empty(())}}

    def restore(self, tree):
        """(shards, optimizer states) of a ``state_tree`` of numpy arrays
        (as ``checkpoint.load_checkpoint`` returns it)."""
        from repro_torch import bridge

        return bridge.train_state_from_numpy(tree["params"], tree["opt"],
                                             self)

    # -- batches ------------------------------------------------------------
    def _rows(self, W: int) -> int:
        """Batch rows per cp group (per rank without cp)."""
        groups = len(self.groups)
        if W % groups or (self.cp == 1 and W != groups):
            raise ValueError(f"batch has {W} rank rows, the step has "
                             f"{self.ranks.n} ranks in {groups} groups")
        return W // groups

    def split_batch(self, batch) -> List[List[dict]]:
        """The (M, W, R) global batch (numpy, from ``build_minibatch``) ->
        per rank, its M microbatches of (W/G, R/cp) tensors on its device:
        group d takes its W/G rows (G groups; one rank, one row without
        cp), and its rank c their c-th contiguous R/cp slice
        (``batch_manual_specs`` of the JAX engine)."""
        M, W, R = batch["tokens"].shape
        rows = self._rows(W)
        if R % self.cp:
            raise ValueError(f"rows of {R} tokens do not split over cp="
                             f"{self.cp}")
        seq = R // self.cp
        out = []
        for r, dev in enumerate(self.ranks.devices):
            d, c = divmod(r, self.cp)
            rs, ss = slice(d * rows, (d + 1) * rows), slice(c * seq,
                                                            (c + 1) * seq)
            mbs = []
            for j in range(M):
                mb = {}
                for k in _BATCH_KEYS:
                    if k not in batch:
                        continue
                    x = torch.from_numpy(np.ascontiguousarray(
                        batch[k][j, rs, ss]))
                    if k in _INDEX_KEYS:
                        x = x.long()
                    mb[k] = x.to(dev)
                for k in _ROW_KEYS:
                    if k in batch:
                        mb[k] = torch.from_numpy(np.ascontiguousarray(
                            batch[k][j, rs])).to(dev)
                mbs.append(mb)
            out.append(mbs)
        return out

    def rank_counts(self, counts: Sequence[int]) -> List[int]:
        """Per batch row microbatch counts (a plan's) -> per rank: every
        rank of a group runs its group's rows' largest count."""
        rows = self._rows(len(counts))
        return [max(counts[d * rows:(d + 1) * rows])
                for d, grp in enumerate(self.groups) for _ in grp]

    # -- the step -----------------------------------------------------------
    def grads(self, shards, batch, counts: Optional[Sequence[int]] = None):
        """Per-rank gradient shards of the mean loss over every rank's
        tokens, and the step's metrics (``_grad_minibatch``).  ``counts``
        gives each batch row's number of real microbatches (the plan's,
        one per rank without cp); the minibatch schedule skips the empty
        padding after them, which adds exactly nothing (except for the moe
        family, whose padding adds its router loss: it runs them all)."""
        mbs = self.split_batch(batch)
        M = len(mbs[0])
        counts = ([M] * self.ranks.n if counts is None or self.moe
                  else self.rank_counts(counts))
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

