"""ODC scatter-accumulate: the hand-written CUDA kernels and their plain
PyTorch versions.

Counterpart of ``repro.kernels.odc_scatter.odc_scatter_accumulate_pallas``
as the JAX package calls it (``repro.kernels.ops.odc_scatter_accumulate``):
rank r's full-size (n*c, ...) contribution -> rank r's (c, ...) chunk,
summed over the ranks in ring order, so the kernel is bitwise equal to the
plain ring.  The wrapper takes the per-rank list of contributions and
returns the per-rank list of chunks; ``order`` is the ring order (ring
position -> rank, None for the natural ring).

``odc_scatter_accumulate`` launches ``csrc/odc_scatter.cu`` once for all
ranks when the inputs lie on a CUDA device, and runs the plain ring
(``odc_scatter_accumulate_plain``) when they lie on the CPU; there is no
other route.  Every rank lies on one card, so the kernel has no ring: each
owner pulls its chunk from every contribution through the pointer table
and sums it in registers in the order the ring's partial sum meets them
(``odc_scatter_accumulate_owner_plain`` is that order written in
PyTorch).  It allocates nothing but the outputs, and no block waits for
another.  ``launches`` counts kernel launches.

``odc_scatter_accumulate_layers`` is the counterpart of
``repro.kernels.odc_scatter.odc_scatter_accumulate_layers_pallas``
(``repro.kernels.ops.odc_scatter_accumulate_layers``): rank r's stacked
(L, n*c, ...) contributions -> its (L, c, ...) sums, each layer summed in
the reference's hop order, the L rings chained through one launch of
``repro_odc_scatter_layers`` on a CUDA device; its plain version
(``odc_scatter_accumulate_layers_plain``) is the plain ring layer by
layer, bitwise equal to the kernel.  The kernel is a cluster kernel whose
hops go through shared memory (``csrc/odc_cluster.cuh``); its launch plan
is ``_ring.chain_plan``, and it allocates nothing but the outputs.
``layers_launches`` counts its launches.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.core.odc import ring_positions
from repro_torch.core.odc import \
    ring_scatter_accumulate as odc_scatter_accumulate_plain
from repro_torch.kernels import _build, _ring

launches = 0
layers_launches = 0
# threads of a block and 16-byte vectors of a contributor each thread
# holds at once (ODC_PULL_THREADS, ODC_PULL_UNROLL in csrc/odc_scatter.cu);
# the default grid's waves of resident blocks (the plan of every pull
# kernel: _ring.pull_blocks_per_rank)
PULL_THREADS = _ring.PULL_THREADS
PULL_UNROLL = 2
PULL_WAVES = _ring.PULL_WAVES

__all__ = ["odc_scatter_accumulate", "odc_scatter_accumulate_plain",
           "odc_scatter_accumulate_owner_plain", "launches",
           "odc_scatter_accumulate_layers",
           "odc_scatter_accumulate_layers_plain", "layers_launches"]


def odc_scatter_accumulate_owner_plain(ys: Sequence[torch.Tensor],
                                       order: Optional[Sequence[int]] = None
                                       ) -> List[torch.Tensor]:
    """The pull kernel's order in PyTorch, owner by owner: with p the ring
    position of owner o, ``acc = y_at(p+1)[o]``, then ``acc = acc +
    y_at(p+t)[o]`` for t = 2..n (positions mod n), each add in the input
    type.  Bitwise ``odc_scatter_accumulate_plain``: the ring's partial
    sum for o meets the contributions in this order."""
    n = len(ys)
    pos = ring_positions(n, order)
    c = ys[0].shape[0] // n
    at = (lambda q: q % n) if order is None else (lambda q: order[q % n])
    outs = []
    for o in range(n):
        acc = ys[at(pos[o] + 1)][o * c:(o + 1) * c]
        for t in range(2, n + 1):
            acc = acc + ys[at(pos[o] + t)][o * c:(o + 1) * c]
        outs.append(acc if n > 1 else acc.clone())
    return outs


def pull_blocks_per_rank(c: int, elem_bytes: int, n: int, cap: int) -> int:
    """The pull kernel's default grid, in blocks for each owner: enough
    for every thread to hold PULL_UNROLL vectors of the chunk, at most
    PULL_WAVES times as many as the card holds at once over all n owners
    (``cap``); each block strides over its share."""
    return _ring.pull_blocks_per_rank(c * elem_bytes, n, cap, PULL_UNROLL)


def odc_scatter_accumulate(ys: Sequence[torch.Tensor],
                           order: Optional[Sequence[int]] = None, *,
                           blocks_per_rank: Optional[int] = None
                           ) -> List[torch.Tensor]:
    """Every rank's owned chunk, summed over the ranks: the CUDA kernel for
    CUDA tensors, the plain ring for CPU tensors.  ``blocks_per_rank``
    overrides the kernel's grid (default ``pull_blocks_per_rank``); any
    grid gives the same bits."""
    global launches
    if ys[0].device.type == "cpu":
        return odc_scatter_accumulate_plain(ys, order)
    device = _ring.check(ys, "odc_scatter_accumulate")
    n = len(ys)
    y = ys[0]
    if y.dim() == 0 or y.shape[0] % n:
        raise ValueError(f"odc_scatter_accumulate: leading dim of "
                         f"{tuple(y.shape)} is not a multiple of {n} ranks")
    c = y.numel() // n
    lib = _build.library("odc_scatter")
    if blocks_per_rank is None:
        code = _ring.DTYPE_CODES[y.dtype]
        with torch.cuda.device(device):
            cap = _ring.capacity(lib, "repro_odc_scatter_capacity", code)
        blocks_per_rank = pull_blocks_per_rank(c, y.element_size(), n, cap)
    _ring.check_grid("odc_scatter_accumulate", blocks_per_rank)
    outs = [torch.empty((y.shape[0] // n,) + tuple(y.shape[1:]),
                        dtype=y.dtype, device=device) for _ in range(n)]
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.repro_odc_scatter(
            _ring.pointers(ys), _ring.pointers(outs),
            _ring.order_table(n, order), n, c, _ring.DTYPE_CODES[y.dtype],
            blocks_per_rank, stream)
    if err != 0:
        raise RuntimeError(f"odc_scatter_accumulate kernel failed to "
                           f"launch: CUDA error {err}")
    launches += 1
    return outs


def odc_scatter_accumulate_layers_plain(ys: Sequence[torch.Tensor],
                                        order: Optional[Sequence[int]] = None,
                                        *, reverse: bool = False
                                        ) -> List[torch.Tensor]:
    """The plain ring of every layer of stacked (L, n*c, ...)
    contributions, layer by layer (from L - 1 down with ``reverse``, the
    order a backward pass produces them; each layer's sum is the same)."""
    L = ys[0].shape[0]
    per = {}
    for l in (reversed(range(L)) if reverse else range(L)):
        per[l] = odc_scatter_accumulate_plain([y[l] for y in ys], order)
    return [torch.stack([per[l][r] for l in range(L)])
            for r in range(len(ys))]


def odc_scatter_accumulate_layers(ys: Sequence[torch.Tensor],
                                  order: Optional[Sequence[int]] = None, *,
                                  reverse: bool = False,
                                  out: Optional[Sequence[torch.Tensor]] = None,
                                  ready: Optional[_ring.LayerReady] = None,
                                  blocks_per_rank: Optional[int] = None
                                  ) -> List[torch.Tensor]:
    """Every rank's (L, c, ...) owned sums from every rank's stacked
    (L, n*c, ...) contributions: one launch of the chained CUDA kernel for
    CUDA tensors, the plain ring per layer for CPU tensors.

    ``reverse``: the rings run from layer L - 1 down to 0.
    ``out``: the sums are added into these tensors (``out += sum``, in
    their type) instead of returned in new ones.
    ``ready``: the kernel waits, before layer l, until ``ready.set(l)``
    has run on the compute stream with the value of the latest
    ``ready.arm()``; on the CPU it is not used.  Every
    ``set`` must be enqueued before this launch, or must be enqueued by
    host code that cannot block on the device (no first launch of a
    kernel: CUDA's lazy module loading may synchronise the context, which
    would wait for this kernel); a layer never set traps after 30 s.
    ``blocks_per_rank`` overrides the grid, in clusters (default: at most
    1/CHAIN_SHARE of the card); a grid that cannot be resident raises."""
    global layers_launches
    y = ys[0]
    n = len(ys)
    if y.dim() < 2 or y.shape[1] % n:
        raise ValueError(f"odc_scatter_accumulate_layers: contributions "
                         f"must be stacked (L, n*c, ...) with n = {n}, got "
                         f"{tuple(y.shape)}")
    L = y.shape[0]
    shape = (L, y.shape[1] // n) + tuple(y.shape[2:])
    if out is not None:
        _ring.check_out(out, y, shape, "odc_scatter_accumulate_layers")
    if y.device.type == "cpu":
        sums = odc_scatter_accumulate_layers_plain(ys, order,
                                                   reverse=reverse)
        if out is None:
            return sums
        for o, s in zip(out, sums):
            o.add_(s)
        return list(out)
    device = _ring.check(ys, "odc_scatter_accumulate_layers")
    c = y[0].numel() // n
    code = _ring.DTYPE_CODES[y.dtype]
    lib = _build.library("odc_scatter")
    smem = _ring.chain_layout("scatter", n).smem_bytes
    with torch.cuda.device(device):
        clusters = _ring.capacity(lib, "repro_odc_scatter_layers_capacity",
                                  code, n, smem)
    plan = _ring.chain_plan("scatter", c, y.element_size(), n, clusters,
                            blocks_per_rank)
    outs = list(out) if out is not None else [
        torch.empty(shape, dtype=y.dtype, device=device) for _ in range(n)]
    ready_ptr, want = None, 0
    if ready is not None:
        ready_ptr, want = ready.words.data_ptr(), ready.value
    _ring.chain_launch(lib.repro_odc_scatter_layers,
                       "odc_scatter_accumulate_layers", ys, outs, order, c,
                       code, L, plan, clusters, device,
                       extra=(int(reverse), int(out is not None), ready_ptr,
                              want))
    layers_launches += 1
    return outs
