"""ODC gather: the hand-written CUDA kernels and their plain PyTorch
versions.

Counterpart of ``repro.kernels.odc_gather.odc_gather_pallas`` as the JAX
package calls it (``repro.kernels.ops.odc_gather``): rank r's (c, ...)
shard -> rank r's (n*c, ...) full tensor, rows of rank s's shard at
``s*c``.  The port's single controller holds every rank, so the wrapper
takes the per-rank list of shards and returns the per-rank list of full
tensors; ``order`` is the ring order (ring position -> rank, None for
the natural ring), as ``repro_torch.core.odc.ring_order`` gives it.

``odc_gather`` launches ``csrc/odc_gather.cu`` once for all ranks when
the shards lie on a CUDA device, and runs the plain ring
(``odc_gather_plain``) when they lie on the CPU; there is no other route.
Every rank lies on one card, so the kernel has no ring: block (b, s)
reads slice b of shard s once and stores it to row s of every output
(``csrc/odc_bcast.cuh``), so the result is the ring's whatever its order,
and the kernel moves bytes, NaN bit patterns included.  It allocates
nothing but the outputs, takes any grid, and no block waits for another.
``launches`` counts kernel launches.

``odc_gather_layers`` is the counterpart of
``repro.kernels.odc_gather.odc_gather_layers_pallas``
(``repro.kernels.ops.odc_gather_layers``): rank r's stacked (L, c, ...)
shard -> its (L, n*c, ...) output, rank s's rows of layer l at
``[l, s*c:(s+1)*c]``, the L rings chained through one launch of
``repro_odc_gather_layers`` on a CUDA device; its plain version
(``odc_gather_layers_plain``) is the plain ring layer by layer.  The
kernel is a cluster kernel whose hops go through shared memory
(``csrc/odc_cluster.cuh``); its launch plan is ``_ring.chain_plan``, and
it allocates nothing but the outputs.  ``layers_launches`` counts its
launches.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.core.odc import ring_gather as odc_gather_plain
from repro_torch.kernels import _build, _ring

launches = 0
layers_launches = 0

__all__ = ["odc_gather", "odc_gather_plain", "launches",
           "odc_gather_layers", "odc_gather_layers_plain", "layers_launches"]


def odc_gather(shards: Sequence[torch.Tensor],
               order: Optional[Sequence[int]] = None, *,
               blocks_per_rank: Optional[int] = None) -> List[torch.Tensor]:
    """Every rank's full tensor from every rank's shard: the CUDA kernel
    for CUDA tensors, the plain ring for CPU tensors.  ``blocks_per_rank``
    overrides the kernel's grid (default ``_ring.pull_blocks_per_rank``);
    any grid gives the same bits."""
    global launches
    if shards[0].device.type == "cpu":
        return odc_gather_plain(shards, order)
    device = _ring.check(shards, "odc_gather")
    n = len(shards)
    x = shards[0]
    nbytes = x.numel() * x.element_size()
    _ring.order_table(n, order)  # the kernel needs none; a bad one raises
    lib = _build.library("odc_gather")
    if blocks_per_rank is None:
        with torch.cuda.device(device):
            cap = _ring.capacity(lib, "repro_odc_gather_capacity")
        blocks_per_rank = _ring.pull_blocks_per_rank(nbytes, n, cap,
                                                     _ring.BCAST_UNROLL)
    _ring.check_grid("odc_gather", blocks_per_rank)
    outs = [torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                        dtype=x.dtype, device=device) for _ in range(n)]
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.repro_odc_gather(_ring.pointers(shards),
                                   _ring.pointers(outs), n, nbytes,
                                   blocks_per_rank, stream)
    if err != 0:
        raise RuntimeError(f"odc_gather kernel failed to launch: CUDA error "
                           f"{err}")
    launches += 1
    return outs


def odc_gather_layers_plain(shards: Sequence[torch.Tensor],
                            order: Optional[Sequence[int]] = None
                            ) -> List[torch.Tensor]:
    """The plain ring of every layer of stacked (L, c, ...) shards, layer
    by layer (the JAX oracle of the chained kernel)."""
    per = [odc_gather_plain([s[l] for s in shards], order)
           for l in range(shards[0].shape[0])]
    return [torch.stack([p[r] for p in per]) for r in range(len(shards))]


def odc_gather_layers(shards: Sequence[torch.Tensor],
                      order: Optional[Sequence[int]] = None, *,
                      out: Optional[Sequence[torch.Tensor]] = None,
                      done: Optional[_ring.LayerDone] = None,
                      blocks_per_rank: Optional[int] = None
                      ) -> List[torch.Tensor]:
    """Every rank's (L, n*c, ...) gathered layers from every rank's stacked
    (L, c, ...) shard: one launch of the chained CUDA kernel for CUDA
    tensors, the plain ring per layer for CPU tensors.

    ``out``: the ranks' output tensors to fill (else new ones).
    ``done``: per-layer completion counters; ``done.wait(l)`` then makes a
    stream wait for layer l of this launch (on the CPU it does nothing).
    ``blocks_per_rank`` overrides the grid, in clusters (default: at most
    1/CHAIN_SHARE of the card); a grid that cannot be resident raises."""
    global layers_launches
    x = shards[0]
    if x.dim() < 2:
        raise ValueError(f"odc_gather_layers: shards must be stacked "
                         f"(L, c, ...), got {tuple(x.shape)}")
    n, L = len(shards), x.shape[0]
    shape = (L, n * x.shape[1]) + tuple(x.shape[2:])
    if out is not None:
        _ring.check_out(out, x, shape, "odc_gather_layers")
    if x.device.type == "cpu":
        full = odc_gather_layers_plain(shards, order)
        if out is None:
            return full
        for o, f in zip(out, full):
            o.copy_(f)
        return list(out)
    device = _ring.check(shards, "odc_gather_layers")
    c, es = x[0].numel(), x.element_size()
    lib = _build.library("odc_gather")
    smem = _ring.chain_layout("gather", n).smem_bytes
    with torch.cuda.device(device):
        clusters = _ring.capacity(lib, "repro_odc_gather_layers_capacity", n,
                                  smem)
    plan = _ring.chain_plan("gather", c, es, n, clusters, blocks_per_rank)
    outs = list(out) if out is not None else [
        torch.empty(shape, dtype=x.dtype, device=device) for _ in range(n)]
    done_ptr = done.words.data_ptr() if done is not None else None
    _ring.chain_launch(lib.repro_odc_gather_layers, "odc_gather_layers",
                       shards, outs, order, c, es, L, plan, clusters, device,
                       extra=(done_ptr,))
    if done is not None:  # n storing threads in each of n * B blocks
        done.advance(n * n * plan.blocks_per_rank)
    layers_launches += 1
    return outs
