"""On-Demand Communication primitives as plain PyTorch over per-rank lists,
the counterpart of ``repro.core.odc`` (ring and collective gather and
scatter-accumulate) for a single controller that holds every rank.

Where the JAX package runs one program per device inside ``shard_map``
and moves data with ``ppermute``, the port holds the ranks of a
``RankGroup`` in one process: rank r's value is element r of a list.  A
ring hop is then "rank r takes what its left neighbour held", and every
primitive keeps the reference's hop order, so the rings here are bitwise
equal to ``repro.core.odc.ring_gather`` / ``ring_scatter_accumulate``:

* ``ring_gather(shards)``: rank r's (c, ...) shard -> every rank's
  (n*c, ...) full tensor, rows of shard s at ``s*c``.
* ``ring_scatter_accumulate(ys)``: rank r's full-size (n*c, ...)
  contribution -> rank r's owned (c, ...) chunk, summed over ranks in
  ring order (``acc = arrived + own``).

``order`` is a ring order (ring position -> rank) from ``ring_order``;
``None`` is the natural ring.  The hand-written kernels
(``repro_torch.kernels.odc_gather`` / ``odc_scatter``) run the same
protocol on the card and take these functions as their plain versions.

The chunked int8 wire format (``quantize_chunked`` /
``dequantize_chunked``) and the compressed rings (``ring_gather_q8`` /
``ring_scatter_accumulate_q8``) of the ``pipe-int8`` backend are the
plain versions of ``repro_torch.kernels.quant``'s kernels, bitwise the
reference's.

``prefetch_scan`` is the overlap schedule's layer loop
(``repro.core.odc.prefetch_scan``): layer l+1's parameters are issued
before layer l computes.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint


def ring_order(n: int, device_profile=None) -> Optional[List[int]]:
    """The ring order a ``DeviceProfile`` asks for on an n-rank ring, or
    None for the natural ring (no profile, a profile of another size, or
    a profile whose order is the natural one) -- ``_ring_order``."""
    if device_profile is None or device_profile.world_size != n:
        return None
    order = list(device_profile.ring_order())
    if order == list(range(n)):
        return None
    return order


def ring_positions(n: int, order: Optional[Sequence[int]]) -> List[int]:
    """rank -> ring position (the inverse of ``order``)."""
    if order is None:
        return list(range(n))
    if sorted(order) != list(range(n)):
        raise ValueError(f"ring order {list(order)} is not a permutation of "
                         f"range({n})")
    pos = [0] * n
    for p, r in enumerate(order):
        pos[r] = p
    return pos


def _at(order, n, p):
    """The rank at ring position p (mod n)."""
    p %= n
    return p if order is None else order[p]


def _left(order, pos, n, r):
    return _at(order, n, pos[r] - 1)


def ring_gather(shards: Sequence[torch.Tensor],
                order: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """ODC gather over the ranks: each rank forwards the shard it holds to
    its right neighbour, n-1 times, and files what arrives at the rows of
    the shard's owner (``repro.core.odc.ring_gather``)."""
    n = len(shards)
    pos = ring_positions(n, order)
    c = shards[0].shape[0]
    bufs = []
    for r, x in enumerate(shards):
        buf = torch.zeros((n * c,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        buf[r * c:(r + 1) * c] = x
        bufs.append(buf)
    cur = list(shards)
    for i in range(n - 1):
        cur = [cur[_left(order, pos, n, r)] for r in range(n)]
        for r in range(n):
            src = _at(order, n, pos[r] - i - 1)
            bufs[r][src * c:(src + 1) * c] = cur[r].to(bufs[r].device)
    return bufs


def ring_scatter_accumulate(ys: Sequence[torch.Tensor],
                            order: Optional[Sequence[int]] = None
                            ) -> List[torch.Tensor]:
    """ODC scatter-accumulate over the ranks: a partial sum travels the
    ring, each rank adding its own contribution to the chunk that just
    arrived (``acc = arrived + own``), so after n-1 hops rank r holds the
    sum of chunk r (``repro.core.odc.ring_scatter_accumulate``)."""
    n = len(ys)
    pos = ring_positions(n, order)
    c = ys[0].shape[0] // n

    def blk(r, off):
        """Rank r's contribution to the chunk owned ``off`` ring positions
        behind it."""
        j = _at(order, n, pos[r] - off)
        return ys[r][j * c:(j + 1) * c]

    acc = [blk(r, 1) for r in range(n)]
    for h in range(1, n):
        arrived = [acc[_left(order, pos, n, r)] for r in range(n)]
        acc = [arrived[r].to(ys[r].device) + blk(r, 1 + h) for r in range(n)]
    return acc


# ===========================================================================
# chunked int8 wire format + compressed (q8) rings
# ===========================================================================
#: values per scale chunk: the wire format of the q8 kernels
#: (1 int8 byte per value + one f32 scale per INT8_CHUNK values)
INT8_CHUNK = 256
#: 1/127 rounded to f32.  The reference writes the scale as
#: ``absmax / 127.0``, and XLA compiles that division by a constant to a
#: product with the constant's f32 reciprocal (every jitted path: the
#: engine, the rings under shard_map, the Pallas kernels); only an eager
#: call divides.  The port computes the compiled form.
INV_127 = float.fromhex("0x1.020408p-7")


def quantize_chunked(x: torch.Tensor, chunk: int = INT8_CHUNK):
    """Symmetric per-chunk int8 quantization (``repro.core.odc.
    quantize_chunked`` as XLA compiles it): ``x`` flattened, zero-padded
    to a multiple of ``chunk``, each chunk scaled by ``absmax * INV_127``
    (1.0 for an all-zero chunk, so zeros round-trip exactly), divided by
    its scale (IEEE), rounded half to even and clamped to +-127.  Returns
    ``(q, scales)``: int8 ``(n_chunks, chunk)`` and f32 ``(n_chunks, 1)``."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.shape[0]) % chunk
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, chunk)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    scales = torch.where(absmax > 0, absmax * INV_127,
                         torch.ones_like(absmax))
    q = torch.clamp(torch.round(blocks / scales), -127, 127).to(torch.int8)
    return q, scales


def dequantize_chunked(q: torch.Tensor, scales: torch.Tensor, shape,
                       dtype=torch.float32) -> torch.Tensor:
    """Invert ``quantize_chunked``: ``(n_chunks, chunk)`` int8 values and
    their scales back to a tensor of ``shape`` (padding dropped)."""
    flat = (q.to(torch.float32) * scales).reshape(-1)
    size = 1
    for s in shape:
        size *= s
    return flat[:size].reshape(shape).to(dtype)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` on f32 tensors with one rounding, as a fused
    multiply-add computes it.  The reference's q8 scatter adds
    ``dequantize_chunked(arrived) + own``, and XLA contracts that product
    and add into one FMA on every jitted path (the ring under shard_map and
    the Pallas kernel alike), so this is what it computes.  Here: the
    product is exact in f64 (an int8 code times an f32 scale), the sum is
    taken in f64 with its rounding error (TwoSum), and a sum that f64
    rounded onto the midpoint of two f32 values is moved one f64 step
    towards the exact sum before the f64 -> f32 rounding."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    f = s.float()
    d = s - f.double()
    up = torch.nextafter(f, torch.full_like(f, float("inf"))).double()
    down = torch.nextafter(f, torch.full_like(f, float("-inf"))).double()
    gap = torch.where(d > 0, up - f.double(), f.double() - down)
    tie = (2 * d.abs() == gap) & (err != 0)
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s)
    s = torch.where(tie, torch.nextafter(s, toward), s)
    return s.float()


def ring_gather_q8(shards: Sequence[torch.Tensor],
                   order: Optional[Sequence[int]] = None,
                   chunk: int = INT8_CHUNK) -> List[torch.Tensor]:
    """Compressed ODC gather (``repro.core.odc.ring_gather_q8``): each
    shard is quantized ONCE at its source, its ``(q, scales)`` relayed
    verbatim hop to hop and dequantized where it lands; a rank's own shard
    lands exactly."""
    n = len(shards)
    pos = ring_positions(n, order)
    c = shards[0].shape[0]
    bufs = []
    for r, x in enumerate(shards):
        buf = torch.zeros((n * c,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        buf[r * c:(r + 1) * c] = x
        bufs.append(buf)
    cur = [quantize_chunked(x, chunk) for x in shards]
    for i in range(n - 1):
        cur = [cur[_left(order, pos, n, r)] for r in range(n)]
        for r, x in enumerate(shards):
            src = _at(order, n, pos[r] - i - 1)
            q, s = cur[r]
            bufs[r][src * c:(src + 1) * c] = dequantize_chunked(
                q.to(x.device), s.to(x.device), x.shape, x.dtype)
    return bufs


def ring_scatter_accumulate_q8(ys: Sequence[torch.Tensor],
                               order: Optional[Sequence[int]] = None,
                               chunk: int = INT8_CHUNK) -> List[torch.Tensor]:
    """Compressed ODC scatter-accumulate
    (``repro.core.odc.ring_scatter_accumulate_q8``): partial sums
    accumulate in f32, but every hop's payload is the chunked int8
    encoding of the outgoing partial sum, requantized at each of the n-1
    hops; the receiver adds ``dequant(arrived) + own`` in the plain ring's
    hop order, as one fused multiply-add (``fma``)."""
    n = len(ys)
    pos = ring_positions(n, order)
    c = ys[0].shape[0] // n

    def blk(r, off):
        j = _at(order, n, pos[r] - off)
        return ys[r][j * c:(j + 1) * c]

    acc = [blk(r, 1) for r in range(n)]
    shape, dtype = acc[0].shape, acc[0].dtype
    size = acc[0].numel()
    for h in range(1, n):
        wire = [quantize_chunked(a, chunk) for a in acc]
        arrived = [wire[_left(order, pos, n, r)] for r in range(n)]
        acc = []
        for r, (q, s) in enumerate(arrived):
            q, s = q.to(ys[r].device), s.to(ys[r].device)
            codes = q.to(torch.float32).reshape(-1)[:size]
            scales = s.expand(q.shape).reshape(-1)[:size]
            own = blk(r, 1 + h).reshape(-1).to(torch.float32)
            acc.append(fma(codes, scales, own).reshape(shape).to(dtype))
    return acc


def collective_gather(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The fused all-gather of the FSDP baseline: every rank gets the
    shards concatenated in rank order."""
    return [torch.cat([s.to(x.device) for s in shards]) for x in shards]


def collective_scatter(ys: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The fused reduce-scatter of the FSDP baseline: rank r gets chunk r
    summed over the ranks, in rank order."""
    n = len(ys)
    c = ys[0].shape[0] // n
    out = []
    for r, y in enumerate(ys):
        acc = ys[0][r * c:(r + 1) * c].to(y.device)
        for s in range(1, n):
            acc = acc + ys[s][r * c:(r + 1) * c].to(y.device)
        out.append(acc)
    return out


def prefetch_scan(body: Callable, x, layer_trees: Callable, num_layers: int,
                  prefetch, remat: bool = False):
    """Layer loop with one-slot-ahead parameter prefetch
    (schedule='overlap'), the counterpart of ``repro.core.odc.
    prefetch_scan`` for a Python loop over every rank at once.

    ``prefetch.issue(i, layer_trees(i))`` starts materializing layer i's
    parameters (the ranks' shard subtrees) and returns a handle;
    ``prefetch.materialize(handle)`` returns the ranks' full layer trees.
    Iteration i issues layer i+1 *before* running ``body(i, x, full)``, so
    layer i+1's gather has no data dependence on layer i's compute.  The
    backward pass mirrors it: layer i+1's gradient scatter is emitted
    before layer i's backward.

    Under ``remat`` each iteration's ``body`` is recomputed in the
    backward pass, with the handle as a saved input: the recompute
    materializes the layer from what was issued and does not issue it
    again (the JAX note: "the gathered layers are saved rather than
    re-gathered").  Unlike the JAX scan, the last iteration issues nothing
    (the JAX carry gathers layer 0 again and discards it)."""
    def step(i, x, handle):
        return body(i, x, prefetch.materialize(handle))

    cur = prefetch.issue(0, layer_trees(0))
    for i in range(num_layers):
        nxt = (prefetch.issue(i + 1, layer_trees(i + 1))
               if i + 1 < num_layers else None)
        if remat:
            x = checkpoint(step, i, x, cur, use_reentrant=False)
        else:
            x = step(i, x, cur)
        cur = nxt
    return x
