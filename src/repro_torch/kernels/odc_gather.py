"""ODC gather: the hand-written CUDA ring kernel and its plain PyTorch
version.

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
``launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.core.odc import ring_gather as odc_gather_plain
from repro_torch.kernels import _build, _ring

launches = 0
_STATE = _ring.RingState()

__all__ = ["odc_gather", "odc_gather_plain", "launches"]


def odc_gather(shards: Sequence[torch.Tensor],
               order: Optional[Sequence[int]] = None, *,
               blocks_per_rank: Optional[int] = None) -> List[torch.Tensor]:
    """Every rank's full tensor from every rank's shard: the CUDA kernel
    for CUDA tensors, the plain ring for CPU tensors.  ``blocks_per_rank``
    overrides the kernel's block count (a launch whose blocks cannot all
    be resident raises)."""
    global launches
    if shards[0].device.type == "cpu":
        return odc_gather_plain(shards, order)
    device = _ring.check(shards, "odc_gather")
    n = len(shards)
    x = shards[0]
    lib = _build.library("odc_gather")
    with torch.cuda.device(device):
        cap = _ring.capacity(lib, "repro_odc_gather_capacity")
    if blocks_per_rank is None:
        blocks_per_rank = _ring.blocks_per_rank(
            x.numel() * x.element_size(), n, cap)
    outs = [torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                        dtype=x.dtype, device=device) for _ in range(n)]
    stages = [torch.empty(2 * x.numel(), dtype=x.dtype, device=device)
              for _ in range(n)]
    _ring.launch(lib.repro_odc_gather, "odc_gather", shards, outs, stages,
                 order, x.numel(), x.element_size(), blocks_per_rank, cap,
                 _STATE, device)
    launches += 1
    return outs
