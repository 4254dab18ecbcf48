"""Weight push: the trainer's shards -> the generator's full parameters,
the PyTorch counterpart of ``repro.posttrain.weight_push``.

Between train steps the generator's parameter copy is refreshed from the
trainer's FSDP shards with the same per-leaf gather the train step runs
(``CommBackend.gather_dim``), outside autograd and one-sided: under
``odc`` and ``odc-overlap`` the single-leaf broadcast kernel of
``kernels.odc_gather`` (one launch per sharded leaf, every rank's side
in it), under ``hier`` and ``pipe`` the two-tier transport, under
``pipe-int8`` with the inter tier on the int8 wire, and under
``collective`` the fused concatenation.  The generator keeps rank 0's
full copy of each leaf on its device (on one card every rank's device);
the other ranks' copies are dropped at once.  Where the gather is exact
the pushed parameters are bitwise the trainer's
(``Trainer.unshard``).

``push_comm_sites`` lists, per sharded leaf, the bytes one push moves, as
the reference's does; ``WeightPusher`` charges ``comm.*{op=push}`` per
push from it when an ``obs.metrics`` registry is active.  Whether a push
stalls the generator is the backend's ``push_blocks_trainer`` (the fused
broadcast of ``collective``: a barrier every decode slot joins; the p2p
family: no barrier).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Tuple

import torch

from repro_torch.core import fsdp
from repro_torch.obs import metrics as obs_metrics


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sites(trainer, shards):
    """(path, dim, shard_bytes, world, group) of every leaf a push
    gathers: each sharded leaf, the stationary expert banks included (the
    generator needs every expert), over more than one rank."""
    n = trainer.ranks.n
    out = []
    for path in fsdp.tree_paths(trainer.dims):
        d = fsdp.get(trainer.dims, path)
        if d is None:
            continue  # replicated: every rank holds it already
        world, group = trainer.backend.leaf_world(d, n)
        if world <= 1:
            continue
        x = fsdp.get(shards[0], path)
        out.append((path, d, float(x.numel() * x.element_size()), world,
                    world if group is None else group))
    return out


def push_comm_sites(trainer, shards) -> List[Tuple[float, int, int]]:
    """Per sharded leaf ``(shard_bytes, world, group)`` of ONE full push
    (``repro.posttrain.weight_push.push_comm_sites``): ``group`` is the
    intra tier's width under the two-tier backends and the world under
    the flat ones."""
    return [(b, w, g) for _, _, b, w, g in _sites(trainer, shards)]


def push_params(trainer, shards, device=None):
    """The full parameter tree on ``device`` (default: rank 0's), every
    sharded leaf gathered with the trainer's backend, no autograd."""
    dev = trainer.ranks.devices[0] if device is None else torch.device(
        device)
    moved = {tuple(p): d for p, d, *_ in _sites(trainer, shards)}
    out = {}
    with torch.no_grad():
        for path in fsdp.tree_paths(trainer.dims):
            leaves = [fsdp.get(s, path) for s in shards]
            d = moved.get(tuple(path))
            if d is None:  # a copy: the trainer may update its own in place
                full = leaves[0].clone()
            elif d == 0 or isinstance(d, fsdp.IntraDim):
                full = trainer.backend.gather_dim(leaves, d,
                                                  trainer.order)[0]
            else:  # lay out only the copy the generator keeps
                rows = [x.movedim(d, 0).contiguous() for x in leaves]
                full = trainer.backend.gather(rows, trainer.order)[0] \
                    .movedim(0, int(d)).contiguous()
            fsdp.put(out, path, full.to(dev))
    return out


@dataclasses.dataclass
class WeightPusher:
    """Push plus version bookkeeping for the pipeline.

    ``push(shards, version)`` refreshes the generator's copy and records
    the trainer version it now holds; ``pushes`` counts the refreshes.
    """

    trainer: Any
    version: int = -1
    pushes: int = 0

    def __post_init__(self):
        self.params = None
        self._push_sites = None
        self.device = self.trainer.ranks.devices[0]

    def _record_push(self, shards):
        """Charge one full push's comm bytes to the active registry."""
        if obs_metrics.active() is None:
            return
        if self._push_sites is None:
            self._push_sites = push_comm_sites(self.trainer, shards)
        for shard_bytes, world, group in self._push_sites:
            self.trainer.backend.record_comm("push", shard_bytes,
                                             world=world, group=group)

    def push(self, shards, version: int):
        self.params = None  # drop the previous copy before the gathers
        self.params = push_params(self.trainer, shards, self.device)
        _sync(self.device)  # a push ends when its bytes have landed
        self._record_push(shards)
        self.version = version
        self.pushes += 1
        return self.params

    @property
    def blocks_generator(self) -> bool:
        """Whether this backend's push is a barrier the decode slots must
        join (``push_blocks_trainer``: True for 'collective', False for
        the p2p family, the paper's non-intrusive push)."""
        return bool(self.trainer.backend.push_blocks_trainer)

    def push_live(self, engine, shards, version: int):
        """Refresh a RUNNING continuous engine between decode steps: the
        push as ``push`` makes it, timed with the device synchronised,
        then published into the engine under the backend's barrier
        semantics (a collective push stalls every decode slot for the
        measured time; a p2p push lands on the push lane only).  In-flight
        requests keep the version they pinned at admission."""
        _sync(self.device)
        t0 = time.perf_counter()
        params = self.push(shards, version)
        dt = time.perf_counter() - t0
        engine.publish(params, version, barrier=self.blocks_generator,
                       push_time=dt)
        return params
