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
when they lie on the CPU; there is no other route.  On the card it takes
one of two hand-written kernels, by ``route``, a pure function of the
shapes, the dtype and the pointers' alignment decided before launch:
bf16 whose rows TMA can address goes to the tensor cores (``"tc"``:
TMA loads, wgmma, f32 accumulation), everything else, f32 included, to
the CUDA cores (``"simt"``: a register-tiled f32 loop).  Within a hop
the kernels sum in another order than the plain version (one f32
accumulator for the whole call).  ``launch_plan`` is each launch's tile
plan.  ``launches`` counts kernel launches, ``launches_tc`` and
``launches_simt`` those of each route.  No engine calls the op (the JAX
package has no caller either): it is a kernel of its own, as
``tests/test_kernels.py`` drives it.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.kernels import _build, _ring

launches = 0
launches_tc = 0
launches_simt = 0

__all__ = ["gather_matmul", "gather_matmul_plain", "route", "launch_plan",
           "launches", "launches_tc", "launches_simt"]

# The tiles of each route (kTc*, kSimt* in csrc/gather_matmul.cu): output
# rows and columns of a block, k step, pipeline stages, threads.  The
# tensor-core route's stages each hold x's (BM, BK) and the shard's (BK,
# BN) bf16 slices, then a full and an empty barrier each, and 1 KB to
# align the base; the CUDA-core route holds two (BK, BM + 4) and (BK, BN)
# f32 slices.
TC_TILE = dict(bm=128, bn=256, bk=64, stages=4, threads=384)
SIMT_TILE = dict(bm=128, bn=128, bk=16, stages=2, threads=256)
TC_SMEM_BYTES = (TC_TILE["stages"] * 2 * TC_TILE["bk"]
                 * (TC_TILE["bm"] + TC_TILE["bn"])
                 + TC_TILE["stages"] * 16 + 1024)
SIMT_SMEM_BYTES = (4 * SIMT_TILE["stages"] * SIMT_TILE["bk"]
                   * (SIMT_TILE["bm"] + 4 + SIMT_TILE["bn"]))
# TMA addresses rows whose byte strides are multiples of this
TMA_ALIGN = 16


def route(n: int, m: int, k: int, f: int, dtype: torch.dtype,
          aligned: bool = True) -> str:
    """"tc" (tensor cores) for bf16 whose rows TMA can address: x's row
    within a shard (c = k/n elements), the shard's and the output's row (f
    elements) multiples of 16 bytes, every pointer 16-byte aligned
    (``aligned``); "simt" (CUDA cores) for everything else."""
    c = k // n
    es = torch.empty((), dtype=dtype).element_size()
    if (dtype == torch.bfloat16 and aligned and (c * es) % TMA_ALIGN == 0
            and (f * es) % TMA_ALIGN == 0):
        return "tc"
    return "simt"


def launch_plan(n: int, m: int, k: int, f: int, dtype: torch.dtype,
                aligned: bool = True) -> dict:
    """The launch of one call: its route, tile, grid (m tiles, f tiles,
    ranks), threads, shared memory bytes of a block, k steps of each hop,
    and the load path ("tma"; "vector": cp.async and float4; "scalar":
    guarded element loads), as ``repro_gather_matmul_plan`` gives it."""
    rt = route(n, m, k, f, dtype, aligned)
    tile = TC_TILE if rt == "tc" else SIMT_TILE
    c = k // n
    if rt == "tc":
        loads = "tma"
    elif (dtype == torch.float32 and aligned and c % 4 == 0
          and f % 4 == 0):
        loads = "vector"
    else:
        loads = "scalar"
    return {"route": rt, **tile,
            "grid": (-(-m // tile["bm"]), -(-f // tile["bn"]), n),
            "smem_bytes": TC_SMEM_BYTES if rt == "tc" else SIMT_SMEM_BYTES,
            "k_steps_per_hop": -(-c // tile["bk"]), "loads": loads}


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
    launch of the CUDA kernel of ``route`` for CUDA tensors, the plain
    version for CPU tensors."""
    global launches, launches_tc, launches_simt
    if xs[0].device.type == "cpu":
        return gather_matmul_plain(xs, w_shards)
    n, m, k, c, f = _check(xs, w_shards)
    device = xs[0].device
    dtype = xs[0].dtype
    outs = [torch.empty((m, f), dtype=dtype, device=device)
            for _ in range(n)]
    aligned = all(t.data_ptr() % TMA_ALIGN == 0
                  for t in (*xs, *w_shards, *outs))
    rt = route(n, m, k, f, dtype, aligned)
    lib = _build.library("gather_matmul")
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (_ring.pointers(xs), _ring.pointers(w_shards),
            _ring.pointers(outs), n, m, k, f)
    with torch.cuda.device(device):
        if rt == "tc":
            err = lib.repro_gather_matmul_tc(*args, stream)
        else:
            err = lib.repro_gather_matmul_simt(
                *args, _ring.DTYPE_CODES[dtype], stream)
    if err != 0:
        raise RuntimeError(f"gather_matmul kernel ({rt} route) failed to "
                           f"launch: CUDA error {err}")
    launches += 1
    if rt == "tc":
        launches_tc += 1
    else:
        launches_simt += 1
    return outs
