"""ODC gather fused with its consumer matmul: the hand-written CUDA kernel
and its plain PyTorch version.

Counterpart of ``repro.kernels.gather_matmul.gather_matmul_pallas`` as
``repro.kernels.ops.gather_matmul`` calls it, with its oracle
``repro.kernels.ref.gather_matmul_ref``: rank r's x ``(m, k)`` and its
``(k/n, f)`` rows of W -> rank r's ``(m, f) = x_r @ W``, without the full W
ever existing.  The port's single controller holds every rank, so the
wrapper takes the per-rank lists ``xs`` and ``w_shards`` and returns the
per-rank list of outputs, as the ring wrappers do (``odc_gather``).

Summation order, the TPU kernel's hop order: out_r = sum over hops i =
0..n-1 of ``x_r[:, cols(s_i)] @ shard_{s_i}`` with s_i = (r - i) mod n,
each hop's product in float32, added to a float32 total, rounded to x's
dtype once.

``gather_matmul`` launches ``csrc/gather_matmul.cu`` once for every rank
when the tensors lie on a CUDA device, and runs ``gather_matmul_plain``
when they lie on the CPU; there is no other route.  ``launches`` counts
kernel launches.  No engine calls the op (the JAX package has no caller
either): it is a kernel of its own, as ``tests/test_kernels.py`` drives it.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.kernels import _build, _ring

launches = 0

__all__ = ["gather_matmul", "gather_matmul_plain", "launches"]


def _check(xs: Sequence[torch.Tensor], w_shards: Sequence[torch.Tensor]):
    """(n, m, k, c, f) of the call; raises on anything either route does
    not take, as the ring kernels do (``_ring.check``)."""
    n = len(xs)
    what = "gather_matmul"
    if len(w_shards) != n:
        raise ValueError(f"{what}: {n} ranks of x, {len(w_shards)} of "
                         f"w_shards")
    x0, w0 = xs[0], w_shards[0]
    if x0.dim() != 2 or w0.dim() != 2:
        raise ValueError(f"{what}: want x (m, k) and w_shard (k/n, f), got "
                         f"{tuple(x0.shape)} and {tuple(w0.shape)}")
    (m, k), (c, f) = x0.shape, w0.shape
    if k != n * c:
        raise ValueError(f"{what}: x has k = {k} columns, {n} shards of "
                         f"{c} rows hold {n * c}")
    device = _ring.check(xs, what)
    if _ring.check(w_shards, what) != device or w0.dtype != x0.dtype:
        raise ValueError(f"{what}: x is {x0.dtype} on {device}, w_shards "
                         f"{w0.dtype} on {w0.device}; they must be alike")
    return n, m, k, c, f


def gather_matmul_plain(xs: Sequence[torch.Tensor],
                        w_shards: Sequence[torch.Tensor]
                        ) -> List[torch.Tensor]:
    """The kernel's function in its hop order: per rank, hop after hop, the
    product with the shard of that hop in float32, summed in float32."""
    n, m, k, c, f = _check(xs, w_shards)
    outs = []
    for r, x in enumerate(xs):
        acc = torch.zeros((m, f), dtype=torch.float32, device=x.device)
        for i in range(n):
            s = (r - i) % n
            acc += (x[:, s * c:(s + 1) * c].float()
                    @ w_shards[s].float())
        outs.append(acc.to(x.dtype))
    return outs


def gather_matmul(xs: Sequence[torch.Tensor],
                  w_shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every rank's ``x_r @ W`` from every rank's x and row shard of W: one
    launch of the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    global launches
    if xs[0].device.type == "cpu":
        return gather_matmul_plain(xs, w_shards)
    n, m, k, c, f = _check(xs, w_shards)
    device = xs[0].device
    outs = [torch.empty((m, f), dtype=xs[0].dtype, device=device)
            for _ in range(n)]
    fn = _build.library("gather_matmul").repro_gather_matmul
    with torch.cuda.device(device):
        err = fn(_ring.pointers(xs), _ring.pointers(w_shards),
                 _ring.pointers(outs), n, m, k, f,
                 _ring.DTYPE_CODES[xs[0].dtype],
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_matmul kernel failed to launch: CUDA "
                           f"error {err}")
    launches += 1
    return outs
