"""The overlap schedule on a ring backend: the trunk's parameters move
through the two chained ring kernels, one launch of each per lockstep
microbatch round, beside the compute on a side stream.

Per train step (``ChainedLayers.begin_step``): each rank's sharded
per-layer leaves are packed into one (L, c_flat) tensor (``LayerPacking``:
the leaves' layer shards side by side, in ``fsdp.tree_paths`` order; for
the hybrid family a "layer" is a super-layer of P mamba blocks, L =
n_super, and the tail and the shared block move through the single-leaf
rings with the top-level leaves; for the moe family a super-layer of P-1
dense blocks and one moe block, L = n_super; the audio encoder-decoder
has two trunks, ``enc_layers`` and ``dec_layers``, each packed and
chained on its own, ``ChainedTrunks``), and
the step owns three per-rank buffers for its whole length: the packed
shards, the gathered trunk (L, n*c_flat) and the packed gradient
(L, c_flat), of which the gradient tree's trunk leaves are views.  The
Trainer's per-leaf shard layout, AdamW and ``unshard`` are unchanged.

Per lockstep round (microbatch j of every rank):

1. ``begin_round``: on the side stream, after the compute stream's work
   so far (the packing, the previous round's backward), one
   ``odc_gather_layers`` launch fills the gathered trunk and counts each
   finished layer in ``LayerDone``.
2. The forward (``core.odc.prefetch_scan``): ``materialize`` of layer l
   makes the compute stream wait for layer l only, then rebuilds the
   ranks' full leaves of layer l from the gathered pieces along each
   leaf's sharded dim (``_Materialize``).  Under remat the recompute of
   layer l rebuilds them again from the same buffer: nothing is gathered
   twice.
3. The backward: once layer l's backward is done (its recompute has read
   the gathered layer), ``_Materialize.backward`` writes layer l's
   cotangents over layer l's slot of the gathered trunk, so one buffer
   serves both rings, and sets layer l's ready flag on the compute stream
   (``LayerReady``, a stream write behind a memory barrier).
4. ``after_backward``: on the side stream, one
   ``odc_scatter_accumulate_layers`` launch, layers L-1 down to 0, whose
   blocks wait for each layer's ready flag and add its sums into the
   packed gradient.  It is enqueued once ``backward()`` has returned,
   i.e. once the host has enqueued the whole backward, every ready flag
   included; the host runs far ahead of the device, so on the device the
   scatter still starts while the backward's first layers compute and
   follows it layer by layer.  Enqueued any earlier, the waiting kernel
   could deadlock the host: CUDA loads a kernel's module at its first
   launch (lazy loading) and may synchronise the context to do so, which
   waits for the scatter, which waits for flags the host has not yet
   enqueued (measured on the H100: the host hung in the first launch of
   a kernel after the scatter until the scatter's 30 s trap).

With two trunks every round launches two chained gathers, the
encoder's then the decoder's, and two chained scatters, the decoder's
then the encoder's (the order their backwards finish in), all on one
side stream: one chained kernel runs at a time, as each assumes that
the rest of the card is free for the compute stream.

``end_step`` makes the compute stream wait for the side stream and
returns the gradient views.  On CPU tensors the same steps run the plain
rings in the same order.  The packing,
unpacking and cotangent copies run under the profiler labels
``overlap.pack``, ``overlap.unpack`` and ``overlap.write_cotangents`` (a
``record_function`` each, a few microseconds of host time when no
profiler runs).

Streams and memory: every buffer the side stream touches is owned by the
step until the compute stream has waited for the side stream, and the
chained kernels allocate nothing on the side stream (their hops go
through shared memory, and their outputs are the step's buffers), so
nothing needs ``record_stream``.  The
single-leaf rings of the top-level leaves run on the compute stream at
most ``1 - 2/CHAIN_SHARE`` of the card, so they are resident beside a
chained kernel that waits for the compute stream.  A device-wide
synchronisation while a chained scatter waits for its ready flags (such
as the caching allocator freeing memory after a failed allocation) would
stall until the kernel's 30 s trap: the overlap run must fit in memory
with room to spare.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
from torch.profiler import record_function

from repro_torch.core import fsdp
from repro_torch.kernels import _ring
from repro_torch.kernels import odc_gather as kgather
from repro_torch.kernels import odc_scatter as kscatter


class LayerPacking:
    """Where each sharded per-layer leaf's layer shard lies in a rank's
    packed (L, c_flat) row, and the conversions between the packed
    buffers and the leaves.  The chained group is ``group``, by default
    ``fsdp.trunk_group``:
    ``layers``, whose L layers are the rows, or the hybrid's ``mamba``,
    whose L = n_super super-layers are (each row the shards of a
    super-layer's P blocks, a layer's leaves of shape (P, ...)), or the
    moe family's ``layers``, whose rows are its super-layers (a moe
    block's leaves, and its P-1 dense blocks' of shape (P-1, ...)), or
    one of the audio family's ``enc_layers`` and ``dec_layers``.
    Replicated per-layer leaves (a dim the rank count does not divide) and
    stationary experts are not packed: each rank computes with its own."""

    def __init__(self, shapes, dims, n: int, group=None):
        self.n = n
        self.group = group or fsdp.trunk_group(dims)
        self.num_layers = None
        self.entries = []  # (path in the layer tree, layer dim, shard shape,
        #                     offset, size)
        self.replicated = []  # paths of replicated per-layer leaves
        lay = dims[self.group]
        off = 0
        for path in fsdp.tree_paths(lay):
            shape = tuple(fsdp.get(shapes[self.group], path).shape)
            self.num_layers = shape[0]
            d = fsdp.get(lay, path)
            if not fsdp.moves(d):
                self.replicated.append(path)
                continue
            shard = list(shape[1:])
            shard[d - 1] //= n
            size = 1
            for s in shard:
                size *= s
            self.entries.append((path, d - 1, tuple(shard), off, size))
            off += size
        self.c_flat = off

    def pack(self, layers, out: torch.Tensor):
        """One rank's stacked shard leaves -> its (L, c_flat) row."""
        L = self.num_layers
        torch.cat([fsdp.get(layers, e[0]).reshape(L, -1)
                   for e in self.entries], dim=1, out=out)

    def grad_views(self, packed: torch.Tensor):
        """The stacked (L, ...) leaf views of one rank's packed row."""
        tree = {}
        for path, _, shard, off, size in self.entries:
            fsdp.put(tree, path, packed[:, off:off + size].view(
                (self.num_layers,) + shard))
        return tree

    def _pieces(self, row: torch.Tensor, entry):
        """(n, *shard) view of every rank's piece of one leaf in a gathered
        (n*c_flat,) layer row."""
        _, _, shard, off, size = entry
        return row.view(self.n, self.c_flat)[:, off:off + size].view(
            (self.n,) + shard)

    def unpack(self, row: torch.Tensor) -> List[torch.Tensor]:
        """A gathered layer row -> the layer's full leaves, each the
        concatenation of the ranks' pieces along its sharded dim (the
        layout ``CommBackend.gather_dim`` gives)."""
        return [torch.cat(list(self._pieces(row, e).unbind(0)), dim=e[1])
                for e in self.entries]

    def write(self, row: torch.Tensor, cts: Sequence[torch.Tensor]):
        """The layer's full-leaf cotangents -> the gathered layer row, each
        split along its sharded dim into the ranks' pieces."""
        for e, ct in zip(self.entries, cts):
            d, shard = e[1], e[2]
            self._pieces(row, e).copy_(
                ct.unflatten(d, (self.n, shard[d])).movedim(d, 0))


class _Materialize(torch.autograd.Function):
    """Forward: wait for layer l of the gather, then rebuild every rank's
    full leaves of layer l.  Backward: write the cotangents over layer l's
    slot of the gathered trunk and set layer l's ready flag.  ``anchor``
    is a scalar that requires grad, so that the backward runs; its
    gradient is None."""

    @staticmethod
    def forward(ctx, chain, layer, anchor):
        ctx.chain, ctx.layer = chain, layer
        chain.done.wait(layer)
        out = []
        with record_function("overlap.unpack"):
            for buf in chain.bufs:
                out += chain.packing.unpack(buf[layer])
        return tuple(out)

    @staticmethod
    def backward(ctx, *cts):
        chain, layer = ctx.chain, ctx.layer
        k = len(chain.packing.entries)
        with record_function("overlap.write_cotangents"):
            for r, buf in enumerate(chain.bufs):
                chain.packing.write(buf[layer], cts[r * k:(r + 1) * k])
        chain.ready.set(layer)
        return None, None, None


class ChainedLayers:
    """The overlap schedule's trunk state for one Trainer: the packing,
    the side stream and the per-layer signals (kept across steps), and
    per step the packed shards, the gathered trunk and the packed
    gradient.  On a card it first checks that stream memory operations
    work, so that a card that refuses them raises before anything runs.
    ``side``: the side stream to run on (default: a new one)."""

    def __init__(self, packing: LayerPacking, devices, order=None,
                 side=None):
        self.packing = packing
        self.n = len(devices)
        self.device = devices[0]
        self.order = order
        L = packing.num_layers
        self.done = _ring.LayerDone(L, self.device)
        self.ready = _ring.LayerReady(L, self.device)
        self.cuda = self.device.type == "cuda"
        self.side = None
        if self.cuda:
            _ring.probe_stream_memops(self.device)
            self.side = side or torch.cuda.Stream(device=self.device)
        self.packed = self.bufs = self.grads = None

    def _side_after_compute(self):
        """The side stream waits for the compute stream's work so far."""
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self.side.wait_event(ev)

    def begin_step(self, shards):
        p, L, n = self.packing, self.packing.num_layers, self.n
        dev = self.device
        dtype = fsdp.get(shards[0], (p.group,) + p.entries[0][0]).dtype
        self.packed = []
        with record_function("overlap.pack"):
            for s in shards:
                row = torch.empty((L, p.c_flat), dtype=dtype, device=dev)
                p.pack(s[p.group], row)
                self.packed.append(row)
        self.bufs = [torch.empty((L, n * p.c_flat), dtype=dtype, device=dev)
                     for _ in range(n)]
        self.grads = [torch.zeros((L, p.c_flat), dtype=dtype, device=dev)
                      for _ in range(n)]

    def begin_round(self):
        self.ready.arm()  # this round's value, before the backward sets it
        if not self.cuda:
            kgather.odc_gather_layers(self.packed, self.order, out=self.bufs)
            return
        self._side_after_compute()
        with torch.cuda.stream(self.side):
            kgather.odc_gather_layers(self.packed, self.order, out=self.bufs,
                                      done=self.done)

    def materialize(self, layer: int, anchor, layer_trees):
        """Every rank's full tree of this layer: the packed leaves from the
        gathered trunk, replicated leaves as the ranks hold them."""
        flat = _Materialize.apply(self, layer, anchor)
        k = len(self.packing.entries)
        out = []
        for r in range(self.n):
            tree = {}
            for e, leaf in zip(self.packing.entries, flat[r * k:(r + 1) * k]):
                fsdp.put(tree, e[0], leaf)
            for path in self.packing.replicated:
                fsdp.put(tree, path, fsdp.get(layer_trees[r], path))
            out.append(tree)
        return out

    def after_backward(self):
        """The round's chained scatter, after the host has enqueued the
        whole backward (on the CPU, the plain rings now that the
        cotangents are in)."""
        if not self.cuda:
            kscatter.odc_scatter_accumulate_layers(
                self.bufs, self.order, reverse=True, out=self.grads)
            return
        with torch.cuda.stream(self.side):
            kscatter.odc_scatter_accumulate_layers(
                self.bufs, self.order, reverse=True, out=self.grads,
                ready=self.ready)

    def end_step(self):
        """Per rank, the stacked gradient leaves of the packed trunk (views
        of the packed gradient); the step's buffers are released."""
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(self.side)
            torch.cuda.current_stream(self.device).wait_event(ev)
        out = [self.packing.grad_views(g) for g in self.grads]
        self.packed = self.bufs = self.grads = None
        return out


class ChainedPrefetch:
    """The ``prefetch`` hook of one lockstep round over ``ChainedLayers``
    (``core.odc.prefetch_scan``): issuing a layer only names it (its
    gather is in flight for every layer already); materializing it waits
    for it and rebuilds it."""

    def __init__(self, chain: ChainedLayers, anchor):
        self.chain, self.anchor = chain, anchor

    def issue(self, layer, layer_trees):
        return layer, layer_trees

    def materialize(self, handle):
        layer, layer_trees = handle
        return self.chain.materialize(layer, self.anchor, layer_trees)


class ChainedTrunks:
    """The overlap schedule's state for one Trainer over every trunk of
    the tree (``fsdp.trunk_groups``): one ``ChainedLayers`` a trunk, in
    forward order, all on one side stream.  A round gathers the trunks
    in forward order and, after the backward, scatters them in reverse."""

    def __init__(self, shapes, dims, devices, order=None):
        n = len(devices)
        self.chains = []
        side = None
        for group in fsdp.trunk_groups(dims):
            chain = ChainedLayers(LayerPacking(shapes, dims, n, group),
                                  devices, order, side=side)
            side = chain.side
            self.chains.append(chain)
        self.device = self.chains[0].device
        self.groups = [c.packing.group for c in self.chains]

    def unpacked(self, shard_tree):
        """A rank's shard tree without the per-layer leaves that the
        chained rings carry: each trunk keeps only its replicated leaves
        (an empty tree when it has none)."""
        out = dict(shard_tree)
        for chain in self.chains:
            p = chain.packing
            layers = {}
            for path in p.replicated:
                fsdp.put(layers, path, fsdp.get(shard_tree[p.group], path))
            out[p.group] = layers
        return out

    def begin_step(self, shards):
        for chain in self.chains:
            chain.begin_step(shards)

    def begin_round(self):
        for chain in self.chains:
            chain.begin_round()

    def prefetch(self, anchor):
        """The round's ``prefetch`` hooks, one per trunk group."""
        return {c.packing.group: ChainedPrefetch(c, anchor)
                for c in self.chains}

    def after_backward(self):
        for chain in reversed(self.chains):
            chain.after_backward()

    def end_step(self):
        """Per rank, {trunk group: its stacked gradient leaves}."""
        views = [chain.end_step() for chain in self.chains]
        return [{c.packing.group: v[r] for c, v in zip(self.chains, views)}
                for r in range(len(views[0]))]
