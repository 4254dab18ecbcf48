"""Communication backends and the schedule-driven gradient loop, the
PyTorch counterpart of ``repro.core.backend`` for the ranks of a
``RankGroup`` held by one controller.

A backend moves parameters and gradients between the ranks' shards and
their full tensors:

  ``collective``  the FSDP baseline: a fused all-gather (concatenation)
                  and reduce-scatter (sum in rank order), plain PyTorch.
  ``odc``         the paper's p2p rings: ``kernels.odc_gather`` and
                  ``kernels.odc_scatter`` -- the hand-written CUDA kernels
                  on the card, the plain rings of ``core.odc`` on the CPU.
                  A ``DeviceProfile``'s ring order is honoured.

  ``odc-overlap`` ``odc`` with the overlap schedule implied (alias
                  ``overlap``, as in the JAX registry).
  ``cp``          context parallelism (alias ``cp-ring``): parameters move
                  as under ``odc`` over the flat data x cp ranks; the
                  ranks form cp groups that sequence-shard their rows and
                  attend through ``core.cp``'s ring (the Trainer's ``cp``).
                  Under 'minibatch' and 'layer'; 'overlap' is not yet
                  ported and raises.

  ``hier``        two-tier ODC over (node, device) ranks (``ranks.Tiers``):
                  a gather is the intra tier's concatenation, then the
                  ring gather kernel over each inter ring (the ranks of
                  one device index across the nodes); a scatter is the
                  ring scatter kernel over the inter rings, then the intra
                  tier's sum-scatter.  A device profile orders the inter
                  ring by node (``DeviceProfile.node_collapse``).  Under
                  'minibatch' and 'layer'; 'overlap' is not yet ported
                  and raises.
  ``pipe``        hier's transport over (pipe, data) ranks, the ``1f1b``
                  schedule implied; bit-exact with ``hier``.
  ``pipe-int8``   ``pipe`` with the inter tier on the chunked int8 wire:
                  ``kernels.quant``'s compressed rings.

``param_gather`` is the differentiable gather: a ``torch.autograd.Function``
over every rank's shard whose backward is the backend's scatter-accumulate
over every rank's cotangent, so differentiating a parameter gather emits
the gradient scatter-accumulate (``CommBackend.param_gather``).

``build_schedule_grad`` places the gathers and scatters:

  ``'layer'``      FSDP: each layer's leaves are gathered inside the layer
                   (again in the recompute), and scattered in its backward,
                   once per microbatch; microbatch j of every rank runs in
                   one autograd graph, ranks with fewer microbatches padded
                   with empty ones as the JAX engine pads them.
  ``'minibatch'``  ODC: every leaf is gathered once per minibatch, each rank
                   runs its own microbatches and accumulates the full-size
                   gradients locally, and one scatter-accumulate per leaf
                   runs at the minibatch's end.  Under cp each group runs
                   its microbatch j in one lockstep forward (its ring
                   attention spans the group), the group's losses summed
                   before the backward.
  ``'overlap'``    'layer' software-pipelined: ranks in lockstep, gathers
                   and scatters once per microbatch, but layer l+1's
                   parameters are issued before layer l computes
                   (``core.odc.prefetch_scan``) and the backward scatters
                   layer l+1 before layer l.  With ``collective`` that is
                   the issue order of plain concatenations; with a ring
                   backend the trunk moves through the chained ring
                   kernels, one gather and one scatter launch per round on
                   a side stream (``core.overlap``), and only the top-level
                   leaves through the single-leaf rings.
  ``'1f1b'``       'minibatch' with each rank's (or cp group's)
                   microbatch forwards and backwards issued in the stage-0
                   ``sim.timeline.instructions_1f1b`` order, at most
                   warmup + 1 graphs live; 'minibatch' is its one-stage
                   case (F0 B0 F1 B1 ...).  Full-size gradients accumulate
                   in backward order, one scatter per leaf at the end.

Under a two-tier layout the norms shard over the intra tier only
(``fsdp.IntraDim``); after the scatters their gradients are summed over
the inter tier, and a replicated leaf's over every rank (the leftover
psum of ``gspmd.make_train_step``).

The moe and audio families run under ``collective``, ``odc`` and
``odc-overlap``; ``resolve`` refuses them under ``cp`` and the two-tier
backends.  The audio family's two trunks, ``enc_layers`` and
``dec_layers``, are each walked by the overlap schedule (and chained on
their own under a ring backend: ``core.overlap.ChainedTrunks``).  Under
weight-stationary expert parallelism (``fsdp.Stationary`` expert leaves)
no schedule gathers or scatters an expert leaf: each rank computes with
its own experts and their gradient lands on its shard through the
exchange's backward (``gspmd._is_stationary_expert``); the 'minibatch'
schedule then runs every rank's microbatch j in one lockstep forward, as
the exchange needs every rank's tokens.  The overlap schedule refuses
it.

Comm-byte accounting (``repro.obs``): ``comm_volume`` is the reference's
volume model per backend (the flat ring: n - 1 messages of one shard;
``collective``: the same bytes in one fused message; the two tiers: one
intra collective plus the inter ring's hops, ``pipe-int8``'s inter tier
on the int8 wire), and ``record_comm`` charges one move to the active
``obs.metrics`` registry under ``comm.messages``, ``comm.bytes_logical``,
``comm.bytes_wire`` and the ``comm.message_bytes`` histogram, labelled
``backend``, ``op`` (``gather``, ``scatter``, ``push``) and ``tier``.
The reference records at trace time, once per gather site of its
compiled step (its per-step ledger), not once per executed gather; the
port runs eagerly and records the same sites once per step
(``record_step``), so the two drivers' ``--metrics`` files hold the same
rows.  With no registry active nothing is recorded.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.core import fsdp, odc, overlap
from repro_torch.core.ranks import Tiers, cp_groups
from repro_torch.kernels import odc_gather as kgather
from repro_torch.kernels import odc_scatter as kscatter
from repro_torch.kernels import quant as kquant
from repro_torch.obs import metrics as obs_metrics
from repro_torch.sim.timeline import instructions_1f1b

SCHEDULES = ("layer", "minibatch", "overlap", "1f1b")


class CommBackend:
    """One communication strategy over the ranks' per-rank lists."""

    name = "?"
    #: the schedule this backend forces (``resolve``), or None
    implied_schedule = None
    #: the overlap schedule moves the trunk through the chained rings
    chained = False
    #: parameters shard over a two-tier (inter, intra) layout
    two_tier = False
    #: whether a trainer->generator weight push is a barrier every rank
    #: and decode slot joins (the fused broadcast of ``collective``), or
    #: one-sided, the generator pulling shards without interrupting their
    #: owners (the p2p family: the paper's non-intrusive push)
    push_blocks_trainer = False

    def ring_order(self, n: int, device_profile=None):
        """The order of this backend's rings over n ranks for a device
        profile (None: natural)."""
        return odc.ring_order(n, device_profile)

    def gather(self, shards, order=None) -> List[torch.Tensor]:
        """Per-rank (c, ...) shards -> per-rank (n*c, ...) full tensors."""
        raise NotImplementedError

    def scatter_accumulate(self, ys, order=None) -> List[torch.Tensor]:
        """Per-rank (n*c, ...) contributions -> per-rank (c, ...) sums."""
        raise NotImplementedError

    def gather_dim(self, shards, dim: int, order=None):
        """``gather`` along ``dim``; the full tensors come back contiguous,
        so every schedule and backend computes with one layout."""
        if dim == 0:
            return self.gather([s.contiguous() for s in shards], order)
        moved = [s.movedim(dim, 0).contiguous() for s in shards]
        return [f.movedim(0, dim).contiguous()
                for f in self.gather(moved, order)]

    def scatter_dim(self, ys, dim: int, order=None):
        """``scatter_accumulate`` along ``dim``."""
        if dim == 0:
            return self.scatter_accumulate([y.contiguous() for y in ys],
                                           order)
        moved = [y.movedim(dim, 0).contiguous() for y in ys]
        return [s.movedim(0, dim)
                for s in self.scatter_accumulate(moved, order)]

    def param_gather(self, shards, dim: int, order=None):
        """Differentiable gather of one leaf over every rank: forward is
        ``gather_dim``, backward ``scatter_dim`` of the cotangents."""
        return list(_ParamGather.apply(self, dim, order, *shards))

    # -- comm-byte accounting (obs.metrics) ---------------------------------
    def wire_factor(self, tier: str) -> float:
        """Wire bytes per logical byte on ``tier`` (compression ratio)."""
        return 1.0

    def comm_volume(self, op: str, shard_bytes: float, world: int,
                    group: Optional[int] = None):
        """``[(tier, messages, logical_bytes, wire_bytes)]`` of moving one
        ``shard_bytes`` shard set over ``world`` ranks (``group``: the
        intra tier's width, for the two-tier backends): the flat p2p ring,
        ``world - 1`` hops of one shard each."""
        if world <= 1:
            return []
        logical = (world - 1) * shard_bytes
        return [("flat", world - 1, logical,
                 logical * self.wire_factor("flat"))]

    def record_comm(self, op: str, shard_bytes: float, *, world: int,
                    group: Optional[int] = None, scale: float = 1.0):
        """Charge one shard-set move (``scale`` of them) to the active
        registry; a no-op without one."""
        reg = obs_metrics.active()
        if reg is None:
            return
        for tier, msgs, logical, wire in self.comm_volume(
                op, shard_bytes, world, group):
            labels = dict(backend=self.name, op=op, tier=tier)
            reg.counter("comm.messages", **labels).inc(msgs * scale)
            reg.counter("comm.bytes_logical", **labels).inc(logical * scale)
            reg.counter("comm.bytes_wire", **labels).inc(wire * scale)
            reg.histogram("comm.message_bytes", **labels).observe(
                wire / msgs if msgs else 0.0, msgs * scale)

    def leaf_world(self, d, n: int):
        """(world, group) of a leaf sharded on ``d`` over n ranks: the
        ranks its gather spans, and the intra tier's width (None: flat)."""
        return n, None

    def __repr__(self):
        return f"<CommBackend {self.name!r}>"


class _ParamGather(torch.autograd.Function):
    """Forward: gather one leaf over every rank; backward: the matching
    scatter-accumulate of every rank's cotangent (a rank whose full
    tensor got no gradient contributes zeros: autograd materializes
    them)."""

    @staticmethod
    def forward(ctx, backend, dim, order, *shards):
        ctx.backend, ctx.dim, ctx.order = backend, dim, order
        return tuple(backend.gather_dim(shards, dim, order))

    @staticmethod
    def backward(ctx, *cts):
        grads = ctx.backend.scatter_dim(cts, ctx.dim, ctx.order)
        return (None, None, None, *grads)


class CollectiveBackend(CommBackend):
    """Fused all-gather / reduce-scatter: the FSDP baseline (no ring, so
    a ring order is ignored)."""

    name = "collective"
    push_blocks_trainer = True  # a fused broadcast is a global barrier

    def comm_volume(self, op, shard_bytes, world, group=None):
        # the ring's logical bytes, fused into one collective launch
        if world <= 1:
            return []
        logical = (world - 1) * shard_bytes
        return [("flat", 1, logical, logical * self.wire_factor("flat"))]

    def gather(self, shards, order=None):
        return odc.collective_gather(shards)

    def scatter_accumulate(self, ys, order=None):
        return odc.collective_scatter(ys)


class ODCBackend(CommBackend):
    """p2p ring gather / scatter-accumulate (paper §3): the hand-written
    ring kernels on CUDA tensors, the plain rings on CPU tensors."""

    name = "odc"
    chained = True

    def gather(self, shards, order=None):
        return kgather.odc_gather(shards, order)

    def scatter_accumulate(self, ys, order=None):
        return kscatter.odc_scatter_accumulate(ys, order)


class OverlapODCBackend(ODCBackend):
    """ODC with the double-buffered prefetch issue order: the same rings
    (bitwise the same values), the overlap schedule implied."""

    name = "odc-overlap"
    implied_schedule = "overlap"


class CpRingBackend(ODCBackend):
    """Context parallelism over (data, cp) ranks (``CpRingBackend`` of the
    JAX package without its simulator hooks): parameter transport is flat
    ODC's over the flat data x cp world, unchanged; what cp adds is
    inside attention, the group's ring (``core.cp``)."""

    name = "cp"
    chained = False


class HierBackend(CommBackend):
    """Hierarchical (node x device) ODC (``HierBackend`` of the JAX
    package without its simulator hooks), over the ``Tiers`` of ``on``:

      gather   shard --intra concatenation--> node chunk
                     --ring gather over the inter ring--> full tensor
      scatter  full  --ring scatter over the inter ring--> node chunk
                     --intra sum-scatter--> owned shard

    One inter ring per device index, each one kernel launch on the card.
    A leaf that shards over the intra tier alone (``fsdp.IntraDim``) uses
    that tier's collective only.  ``order`` is the inter ring's order over
    the nodes (``ring_order``)."""

    name = "hier"
    two_tier = True
    #: the inter tier rides the chunked int8 wire
    compress = False

    def __init__(self, tiers: Tiers = None):
        self.tiers = tiers

    def on(self, tiers: Tiers) -> "HierBackend":
        """This backend over a two-tier layout."""
        return type(self)(tiers)

    def leaf_world(self, d, n):
        if isinstance(d, fsdp.IntraDim):  # one intra collective
            return d.intra, d.intra
        return n, self._layout(n).intra

    def comm_volume(self, op, shard_bytes, world, group=None):
        """Two tiers: one fused intra collective per move plus ``nodes -
        1`` node-level hops, each node holding a ``group``-shard chunk;
        ``group >= world`` (or none) is one intra collective (a leaf of
        the intra tier alone)."""
        if world <= 1:
            return []
        g = group or world
        if g >= world:
            logical = (world - 1) * shard_bytes
            return [("intra", 1, logical,
                     logical * self.wire_factor("intra"))]
        nodes = world // g
        intra = (g - 1) * shard_bytes  # this node's chunk but my shard
        inter = (nodes - 1) * g * shard_bytes  # the other nodes' chunks
        return [
            ("intra", 1, intra, intra * self.wire_factor("intra")),
            ("inter", nodes - 1, inter, inter * self.wire_factor("inter")),
        ]

    def _layout(self, n: int) -> Tiers:
        if self.tiers is None or self.tiers.n != n:
            raise ValueError(f"comm {self.name!r} needs the two-tier layout "
                             f"of its {n} ranks (backend.on(Tiers)), got "
                             f"{self.tiers}")
        return self.tiers

    def ring_order(self, n: int, device_profile=None):
        """The inter ring's order over the nodes (``_node_profile``): a
        profile of the nodes as it is, a profile of every rank collapsed
        to node granularity (a node is gated by its slowest device), any
        other profile ignored (the natural ring)."""
        t = self._layout(n)
        prof = None
        if device_profile is not None:
            if device_profile.world_size == t.inter:
                prof = device_profile
            elif device_profile.world_size == t.n:
                prof = device_profile.node_collapse(t.intra)
        return odc.ring_order(t.inter, prof)

    def _ring_gather(self, xs, order):
        if self.compress:
            return kquant.odc_gather_q8(xs, order)
        return kgather.odc_gather(xs, order)

    def _ring_scatter(self, ys, order):
        if self.compress:
            return kquant.odc_scatter_accumulate_q8(ys, order)
        return kscatter.odc_scatter_accumulate(ys, order)

    def gather(self, shards, order=None):
        t = self._layout(len(shards))
        node = list(shards)
        if t.intra > 1:
            for grp in t.intra_groups():
                for r, f in zip(grp, odc.collective_gather(
                        [shards[r] for r in grp])):
                    node[r] = f
        out = [None] * t.n
        for ring in t.inter_rings():
            for r, f in zip(ring, self._ring_gather([node[r] for r in ring],
                                                    order)):
                out[r] = f
        return out

    def scatter_accumulate(self, ys, order=None):
        t = self._layout(len(ys))
        node = [None] * t.n
        for ring in t.inter_rings():
            for r, s in zip(ring, self._ring_scatter([ys[r] for r in ring],
                                                     order)):
                node[r] = s
        if t.intra == 1:
            return node
        out = [None] * t.n
        for grp in t.intra_groups():
            for r, s in zip(grp, odc.collective_scatter(
                    [node[r] for r in grp])):
                out[r] = s
        return out

    def _intra(self, fn, xs, dim):
        """``fn`` (a collective over one group's list, on dim 0) over
        each intra group, along ``dim``."""
        t = self._layout(len(xs))
        moved = [x.movedim(dim, 0).contiguous() for x in xs]
        out = [None] * t.n
        for grp in t.intra_groups():
            for r, y in zip(grp, fn([moved[r] for r in grp])):
                out[r] = y.movedim(0, dim).contiguous()
        return out

    def gather_dim(self, shards, dim: int, order=None):
        if isinstance(dim, fsdp.IntraDim):
            return self._intra(odc.collective_gather, shards, dim)
        return super().gather_dim(shards, dim, order)

    def scatter_dim(self, ys, dim: int, order=None):
        if isinstance(dim, fsdp.IntraDim):
            return self._intra(odc.collective_scatter, ys, dim)
        return super().scatter_dim(ys, dim, order)


class PipeBackend(HierBackend):
    """Pipeline-parallel ODC over (pipe, data) ranks: hier's transport
    with the pipe tier as the inter tier and data as the intra tier, the
    ``1f1b`` schedule implied (``PipeBackend`` of the JAX package without
    its simulator hooks).  With ``compress`` off the bytes moved are
    bit-exact with ``hier``'s on the same layout."""

    name = "pipe"
    implied_schedule = "1f1b"


class PipeInt8Backend(PipeBackend):
    """``pipe`` with the inter tier's rings on the chunked int8 wire
    (``kernels.quant``); the intra tier stays full precision."""

    name = "pipe-int8"
    compress = True
    #: chunked-int8 wire bytes per f32 value: one code byte and one f32
    #: scale per ``odc.INT8_CHUNK`` values, against 4 bytes
    int8_wire_factor = (1.0 + 4.0 / odc.INT8_CHUNK) / 4.0

    def wire_factor(self, tier):
        # only the inter tier rides the int8 wire
        return self.int8_wire_factor if tier == "inter" else 1.0


COLLECTIVE = CollectiveBackend()
ODC = ODCBackend()
ODC_OVERLAP = OverlapODCBackend()
CP = CpRingBackend()
HIER = HierBackend()
PIPE = PipeBackend()
PIPE_INT8 = PipeInt8Backend()
_REGISTRY = {"collective": COLLECTIVE, "odc": ODC,
             "odc-overlap": ODC_OVERLAP, "overlap": ODC_OVERLAP,
             "cp": CP, "cp-ring": CP, "hier": HIER, "pipe": PIPE,
             "pipe-int8": PIPE_INT8}


def backend_names():
    """Every registry name, aliases included."""
    return tuple(sorted(_REGISTRY))


def get_backend(name) -> CommBackend:
    if isinstance(name, CommBackend):
        return name
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise ValueError(f"unknown comm backend {name!r}; one of "
                     f"{backend_names()}")


def resolve(comm, schedule: str, *, moe: bool = False, ep: bool = False,
            audio: bool = False):
    """(backend, schedule) for an engine config: the backend may force its
    implied schedule (``comm='odc-overlap'`` => ``schedule='overlap'``);
    otherwise the caller's schedule is honoured unchanged.  ``moe``: the
    model is of the moe family; ``ep``: with weight-stationary expert
    parallelism; ``audio``: of the audio encoder-decoder family."""
    backend = get_backend(comm)
    schedule = backend.implied_schedule or schedule
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; one of {SCHEDULES}")
    if schedule == "overlap" and (backend is CP or backend.two_tier):
        raise NotImplementedError(
            f"comm {backend.name!r} under the overlap schedule is not yet "
            f"ported to repro_torch (ROADMAP.md queue 1); use schedule "
            f"'minibatch' or 'layer'")
    if moe and (backend is CP or backend.two_tier):
        raise NotImplementedError(
            f"the moe family under comm {backend.name!r} is not yet ported "
            f"to repro_torch (ROADMAP.md queue 1 item 12); use comm "
            f"'collective', 'odc' or 'odc-overlap'")
    if audio and (backend is CP or backend.two_tier):
        raise NotImplementedError(
            f"the audio family under comm {backend.name!r} is not yet "
            f"ported to repro_torch (ROADMAP.md queue 1 item 14); use comm "
            f"'collective', 'odc' or 'odc-overlap'")
    if ep and schedule == "overlap":
        raise NotImplementedError(
            "weight-stationary expert parallelism under the overlap "
            "schedule is not yet ported to repro_torch (ROADMAP.md queue 1 "
            "item 13); use schedule 'minibatch' or 'layer'")
    return backend, schedule


# ===========================================================================
# the comm ledger of one step (obs.metrics)
# ===========================================================================
def comm_sites(backend, dims, shard, n: int):
    """``(path, shard_bytes, world, group)`` of every leaf of one rank's
    shard tree that moves over more than one rank (the leaves a gather
    or a weight push carries bytes for)."""
    out = []
    for path in fsdp.tree_paths(dims):
        d = fsdp.get(dims, path)
        if not fsdp.moves(d):
            continue
        world, group = backend.leaf_world(d, n)
        if world > 1:
            x = fsdp.get(shard, path)
            out.append((path, float(x.numel() * x.element_size()), world,
                        group))
    return out


def record_step(backend, schedule: str, dims, shard, n: int):
    """Charge one train step's gathers and scatters to the active
    registry, site by site as the reference's per-step ledger counts them
    (one record per gather site of its compiled step, repeats by trace,
    not by execution):

      'minibatch', '1f1b'  each leaf gathered once and scattered once;
      'layer'       a leaf that is not stacked once each; a stacked leaf
                    one block's slice, gathered twice (the layer body's
                    forward and its rematerialized forward) and scattered
                    once;
      'overlap'     a trunk's leaf (``fsdp.trunk_groups``) one slice of
                    its first stack dim (a layer, or a super-layer),
                    gathered L + 2 times (the first prefetch, the scan
                    body's prefetch scaled by its L iterations, and the
                    rematerialized body's) and scattered twice; the other
                    leaves as under 'layer'.

    Microbatches do not multiply the records, as they do not in the
    reference."""
    if obs_metrics.active() is None:
        return
    trunks = (set(fsdp.trunk_groups(dims)) if schedule == "overlap"
              else set())
    for path, nbytes, world, group in comm_sites(backend, dims, shard, n):
        depth = fsdp.stack_depth(path)
        shape = fsdp.get(shard, path).shape
        if depth == 0 or schedule in ("minibatch", "1f1b"):
            size, gathers, scatters = nbytes, 1, 1
        elif path[0] in trunks:
            size, gathers, scatters = nbytes / shape[0], shape[0] + 2, 2
        else:
            size, gathers, scatters = (nbytes / math.prod(shape[:depth]),
                                       2, 1)
        backend.record_comm("gather", size, world=world, group=group,
                            scale=gathers)
        backend.record_comm("scatter", size, world=world, group=group,
                            scale=scatters)


# ===========================================================================
# the schedule-driven gradient loop over all ranks
# ===========================================================================
def _gather_trees(backend, trees, dims, order, differentiable):
    """Per-rank trees -> per-rank trees with every sharded leaf gathered
    (one call over all ranks per leaf)."""
    out = [dict() for _ in trees]
    for path in fsdp.tree_paths(dims):
        d = fsdp.get(dims, path)
        leaves = [fsdp.get(t, path) for t in trees]
        if not fsdp.moves(d):
            full = leaves
        elif differentiable:
            full = backend.param_gather(leaves, d, order)
        else:
            full = backend.gather_dim(leaves, d, order)
        for o, f in zip(out, full):
            fsdp.put(o, path, f)
    return out


def trainable(tree):
    """(compute tree, gradient tree) over a tree of tensors: each leaf
    becomes a leaf tensor that requires grad, and each stacked leaf (a
    group of ``fsdp.stack_depth`` > 0) becomes nested lists, one level per
    stack dim, of per-layer leaf tensors (views), so that a layer's
    gradient lands in its slice without a full-size temporary.  Every
    ``.grad`` is preset to a view of a zeroed buffer, which autograd then
    accumulates into in place; the gradient tree holds the buffers."""
    def views(x, g, depth):
        if depth == 0:
            t = x.detach().requires_grad_(True)
            t.grad = g
            return t
        return [views(x[i], g[i], depth - 1) for i in range(x.shape[0])]

    compute, grads = {}, {}
    for path in fsdp.tree_paths(tree):
        x = fsdp.get(tree, path)
        g = torch.zeros_like(x)
        fsdp.put(compute, path, views(x, g, fsdp.stack_depth(path)))
        fsdp.put(grads, path, g)
    return compute, grads


def _stacked(tree):
    """A tree whose leaves may be lists of per-layer views -> the same
    tree with each list stacked (differentiably) into one tensor."""
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return torch.stack([_stacked(v) for v in tree])
    return tree


def _unit_dims(dims):
    """The dims of every subtree that ``pxform`` is handed, keyed by its
    top-level keys: the top-level leaves, and one block of each stacked
    kind (the hybrid's ``mamba`` and ``mamba_tail`` blocks have the same
    leaves, sharded alike, so they share a key; the moe family's moe and
    dense blocks, and the audio family's encoder and decoder blocks (the
    latter with ``cross`` and ``cross_norm``), have keys of their own)."""
    units = {frozenset(fsdp.top_dims(dims)): fsdp.top_dims(dims)}
    for d in fsdp.block_dims(dims):
        units[frozenset(d)] = d
    return units


def build_schedule_grad(schedule: str, *, loss_ranks: Callable, backend,
                        dims, order=None, chain=None, cp: int = 1,
                        pipe_stages: int = 1, pipe_interleave: bool = False,
                        lockstep: bool = False):
    """The gradient loop of one minibatch over all ranks.

      loss_ranks(params_list, batches, pxform, prefetch)
                  -> [(nll_sum, tokens)]
                  one lockstep forward of the ranks' batches (whole cp
                  groups of adjacent ranks)
      cp          the cp group size (1: every rank alone)
      dims        tree of each leaf's sharded dim (``fsdp.leaf_dims``)
      order       the rings' order (None = natural)
      chain       schedule 'overlap' with a ring backend: the Trainer's
                  ``core.overlap.ChainedTrunks``
      pipe_stages, pipe_interleave
                  schedule '1f1b': the depth and variant of the stage-0
                  ``instructions_1f1b`` order
      lockstep    'minibatch' and '1f1b': every rank's microbatch j in one
                  forward (weight-stationary expert parallelism, whose
                  exchange spans the ranks), as if one cp group held them

    Returns grad_core(shards, microbatches, counts) -> (lsums, toks,
    grads): per rank, the nll sum and token count over its microbatches
    and its (un-normalized) gradient shards.  ``microbatches[r]`` is rank
    r's list of M padded microbatches; ``counts[r]`` how many of them are
    real (the rest are empty padding; every rank of a cp group has its
    group's count).
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; one of {SCHEDULES}")
    if schedule == "1f1b" and pipe_stages < 1:
        raise ValueError(f"schedule '1f1b' needs pipe_stages >= 1, got "
                         f"{pipe_stages}")
    units = _unit_dims(dims)
    # the groups the overlap schedule's prefetch walks, one slice of its
    # first stack dim at a time (a layer, or a hybrid super-layer)
    slice_dims = {g: fsdp.layer_dims(dims, g, 1)
                  for g in fsdp.trunk_groups(dims)}

    def zero(t):
        return torch.zeros((), dtype=torch.float32, device=t.device)

    if schedule in ("minibatch", "1f1b"):
        stages = pipe_stages if schedule == "1f1b" else 1

        def grad_core(shards, microbatches, counts):
            n = len(shards)
            record_step(backend, schedule, dims, shards[0], n)
            full = _gather_trees(backend, shards, dims, order, False)
            lsums = [zero(fsdp.get(s, ("final_norm",))) for s in shards]
            toks = list(lsums)
            grads_full = [None] * n
            for grp in cp_groups(n, n if lockstep else cp):
                compute = {}
                for r in grp:
                    compute[r], grads_full[r] = trainable(full[r])
                # the group's summed loss of each microbatch in flight,
                # until its backward
                pending = {}
                for op, j in instructions_1f1b(
                        max(counts[r] for r in grp), stages,
                        interleave=pipe_interleave):
                    if op == "B":
                        pending.pop(j).backward()
                        continue
                    outs = loss_ranks([compute[r] for r in grp],
                                      [microbatches[r][j] for r in grp],
                                      None, None)
                    pending[j] = sum((l for l, _ in outs[1:]), outs[0][0])
                    for i, r in enumerate(grp):
                        lsums[r] = lsums[r] + outs[i][0].detach()
                        toks[r] = toks[r] + outs[i][1]
                    del outs
                assert not pending, "1F1B order left unpaired forwards"
                del compute
                for r in grp:
                    full[r] = None  # the gathered leaves are not needed now
            # one scatter-accumulate per leaf, over every rank at once
            grads = [dict() for _ in range(n)]
            for path in fsdp.tree_paths(dims):
                d = fsdp.get(dims, path)
                ys = [fsdp.get(g, path) for g in grads_full]
                out = backend.scatter_dim(ys, d, order) if fsdp.moves(d) \
                    else ys
                for g, o in zip(grads, out):
                    fsdp.put(g, path, o)
                for g in grads_full:
                    fsdp.put(g, path, None)
            _sum_leftover(grads, dims, backend)
            return lsums, toks, grads

        return grad_core

    def pxform(trees):
        """Gather every sharded leaf of these per-rank subtrees (the
        top-level leaves, or one layer's slice) through ``param_gather``."""
        return _gather_trees(backend, trees, units[frozenset(trees[0])],
                             order, True)

    chained = schedule == "overlap" and chain is not None

    def grad_core(shards, microbatches, counts):
        n = len(shards)
        M = len(microbatches[0])
        record_step(backend, schedule, dims, shards[0], n)
        if chained:
            # the trunk's sharded leaves move through the chained rings;
            # the top-level leaves and replicated per-layer leaves are
            # trainable here, as in the 'layer' schedule
            chain.begin_step(shards)
            pairs = [trainable(chain.unpacked(s)) for s in shards]
            for c, _ in pairs:
                for group in chain.groups:
                    c.setdefault(group, {})
        else:
            pairs = [trainable(s) for s in shards]
        compute = [c for c, _ in pairs]
        lsums = [zero(fsdp.get(s, ("final_norm",))) for s in shards]
        toks = list(lsums)
        for j in range(M):
            if chained:
                chain.begin_round()
                anchor = torch.zeros((), device=chain.device,
                                     requires_grad=True)
                prefetch = chain.prefetch(anchor)
            elif schedule == "overlap":
                prefetch = {g: _LayerPrefetch(backend, d, order)
                            for g, d in slice_dims.items()}
            else:
                prefetch = None
            outs = loss_ranks(compute, [microbatches[r][j] for r in range(n)],
                              pxform, prefetch)
            total = outs[0][0]
            for l, _ in outs[1:]:
                total = total + l
            total.backward()
            if chained:
                chain.after_backward()
            for r, (l, t) in enumerate(outs):
                lsums[r] = lsums[r] + l.detach()
                toks[r] = toks[r] + t
        grads = [g for _, g in pairs]
        if chained:
            for g, trunks in zip(grads, chain.end_step()):
                for path in fsdp.tree_paths(trunks):
                    fsdp.put(g, path, fsdp.get(trunks, path))
        _sum_leftover(grads, dims, backend)
        return lsums, toks, grads

    return grad_core


def _sum_leftover(grads, dims, backend):
    """The leftover psum, in place: a replicated leaf's gradient summed
    over every rank, an ``IntraDim`` leaf's (already scattered over its
    intra tier) over the inter tier; a stationary leaf's is its rank's
    own."""
    n = len(grads)
    for path in fsdp.tree_paths(dims):
        d = fsdp.get(dims, path)
        if d is None:
            groups = [range(n)]
        elif isinstance(d, fsdp.IntraDim):
            groups = backend.tiers.inter_rings()
        else:
            continue
        ys = [fsdp.get(g, path) for g in grads]
        for grp in groups:
            for r, o in zip(grp, _sum_over_ranks([ys[r] for r in grp])):
                fsdp.put(grads[r], path, o)


class _LayerPrefetch:
    """The overlap schedule's hook without chained rings: issuing layer i
    (a hybrid super-layer: its P blocks' views stacked) gathers its
    sharded leaves through ``param_gather`` (for ``collective``, plain
    concatenations), and the gathered trees are what the layer computes
    with."""

    def __init__(self, backend, slice_dims, order):
        self.backend, self.slice_dims, self.order = backend, slice_dims, \
            order

    def issue(self, layer, trees):
        return _gather_trees(self.backend, [_stacked(t) for t in trees],
                             self.slice_dims, self.order, True)

    def materialize(self, full):
        return full


def _sum_over_ranks(ys: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """psum over the ranks, in rank order, on every rank's device."""
    out = []
    for y in ys:
        acc = ys[0].to(y.device)
        for other in ys[1:]:
            acc = acc + other.to(y.device)
        out.append(acc)
    return out
