"""ODC scatter-accumulate: the hand-written CUDA ring kernel and its plain
PyTorch version.

Counterpart of ``repro.kernels.odc_scatter.odc_scatter_accumulate_pallas``
as the JAX package calls it (``repro.kernels.ops.odc_scatter_accumulate``):
rank r's full-size (n*c, ...) contribution -> rank r's (c, ...) chunk,
summed over the ranks hop by hop in ring order (``acc = arrived + own``),
so the kernel is bitwise equal to the plain ring.  The wrapper takes the
per-rank list of contributions and returns the per-rank list of chunks;
``order`` is the ring order (ring position -> rank, None for the natural
ring).

``odc_scatter_accumulate`` launches ``csrc/odc_scatter.cu`` once for all
ranks when the inputs lie on a CUDA device, and runs the plain ring
(``odc_scatter_accumulate_plain``) when they lie on the CPU; there is no
other route.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.core.odc import \
    ring_scatter_accumulate as odc_scatter_accumulate_plain
from repro_torch.kernels import _build, _ring

launches = 0
_STATE = _ring.RingState()

__all__ = ["odc_scatter_accumulate", "odc_scatter_accumulate_plain",
           "launches"]


def odc_scatter_accumulate(ys: Sequence[torch.Tensor],
                           order: Optional[Sequence[int]] = None, *,
                           blocks_per_rank: Optional[int] = None
                           ) -> List[torch.Tensor]:
    """Every rank's owned chunk, summed over the ranks: the CUDA kernel for
    CUDA tensors, the plain ring for CPU tensors.  ``blocks_per_rank``
    overrides the kernel's block count (a launch whose blocks cannot all
    be resident raises)."""
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
    code = _ring.DTYPE_CODES[y.dtype]
    lib = _build.library("odc_scatter")
    with torch.cuda.device(device):
        cap = _ring.capacity(lib, "repro_odc_scatter_capacity", code)
    if blocks_per_rank is None:
        blocks_per_rank = _ring.blocks_per_rank(c * y.element_size(), n, cap)
    outs = [torch.empty((y.shape[0] // n,) + tuple(y.shape[1:]),
                        dtype=y.dtype, device=device) for _ in range(n)]
    stages = [torch.empty(2 * c, dtype=y.dtype, device=device)
              for _ in range(n)]
    _ring.launch(lib.repro_odc_scatter, "odc_scatter_accumulate", ys, outs,
                 stages, order, c, code, blocks_per_rank, cap, _STATE,
                 device)
    launches += 1
    return outs
