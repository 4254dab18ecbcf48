"""The chunked int8 codec and the compressed (q8) ODC rings of the
``pipe-int8`` backend: hand-written CUDA kernels and their plain PyTorch
versions.

Counterpart of ``repro.kernels.quant`` as the JAX package calls it
(``repro.kernels.ops``: ``_chunk_blocks``, ``quantize_int8``,
``dequantize_int8``, ``odc_gather_q8``, ``odc_scatter_accumulate_q8``).
The wire format is ``repro_torch.core.odc.quantize_chunked``'s: each
``INT8_CHUNK`` = 256 values as int8 codes plus one f32 scale
(``absmax * fl(1/127)``, 1.0 for an all-zero chunk), 1 + 4/256 bytes a
value.

* ``quantize_int8(x)`` -> ``(q, scales)``, ``(n_chunks, 256)`` int8 and
  ``(n_chunks, 1)`` f32; ``dequantize_int8(q, scales, shape)`` inverts it.
  Kernels: ``repro_quantize`` and ``repro_dequantize`` of
  ``csrc/quant.cu``.
* ``odc_gather_q8(shards, order)``: rank r's (c, ...) shard -> its
  (n*c, ...) full tensor, every other shard quantized ONCE at its origin
  and moved verbatim (``gather_codes``: ``repro_odc_gather_q8`` of
  ``csrc/odc_q8.cu``, the read-once broadcast of ``csrc/odc_bcast.cuh``
  over the codes and the scales, no ring), decoded where it lands, the
  rank's own shard written back exactly.
* ``odc_scatter_accumulate_q8(ys, order)``: rank r's (n*c, ...)
  contribution -> its (c, ...) chunk summed over the ranks, the partial
  sum requantized at every hop (``repro_odc_scatter_q8``).

The zero padding of a ragged tail is the wrapper's, as in
``ops._chunk_blocks``: the kernels see whole chunks only.  Each wrapper
launches its kernel when its inputs lie on a CUDA device and runs the
plain version of ``core.odc`` when they lie on the CPU; there is no other
route.  ``quantize_launches``, ``dequantize_launches``,
``gather_launches`` and ``scatter_launches`` count kernel launches (the
gather's encode and decode count as codec launches).  The kernels are
bitwise their plain versions: a scale is ``absmax * fl(1/127)`` and a
code ``rint(x / scale)`` (IEEE division, round half to even), and the
scatter's ``dequant(arrived) + own`` is one fused multiply-add in the
reference's hop order -- what XLA compiles the reference's arithmetic to
(``core.odc.INV_127``, ``core.odc.fma``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.core import odc
from repro_torch.core.odc import INT8_CHUNK
from repro_torch.kernels import _build, _ring

quantize_launches = 0
dequantize_launches = 0
gather_launches = 0
scatter_launches = 0
_SCATTER_STATE = _ring.RingState()

__all__ = ["quantize_int8", "dequantize_int8", "gather_codes",
           "odc_gather_q8", "odc_scatter_accumulate_q8", "quantize_launches",
           "dequantize_launches", "gather_launches", "scatter_launches"]


def _chunk_blocks(x: torch.Tensor, chunk: int = INT8_CHUNK) -> torch.Tensor:
    """Flatten + zero-pad to the (n_chunks, chunk) f32 codec layout."""
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.shape[0]) % chunk
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, chunk)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels load 16
    bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel failed to launch: CUDA error "
                           f"{err}")


def _encode(blocks: torch.Tensor):
    """(q, scales) of (n_chunks, 256) f32 blocks on the card: one launch."""
    global quantize_launches
    nc = blocks.shape[0]
    q = torch.empty((nc, INT8_CHUNK), dtype=torch.int8, device=blocks.device)
    scales = torch.empty((nc, 1), dtype=torch.float32, device=blocks.device)
    if nc == 0:
        return q, scales
    blocks = _aligned(blocks)
    lib = _build.library("quant")
    stream = torch.cuda.current_stream(blocks.device).cuda_stream
    with torch.cuda.device(blocks.device):
        _check(lib.repro_quantize(blocks.data_ptr(), q.data_ptr(),
                                  scales.data_ptr(), nc, stream),
               "quantize_int8")
    quantize_launches += 1
    return q, scales


def _decode(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(n_chunks, 256) f32 of codes and scales on the card: one launch."""
    global dequantize_launches
    nc = q.shape[0]
    out = torch.empty((nc, INT8_CHUNK), dtype=torch.float32, device=q.device)
    if nc == 0:
        return out
    q, scales = _aligned(q), _aligned(scales)
    lib = _build.library("quant")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        _check(lib.repro_dequantize(q.data_ptr(), scales.data_ptr(),
                                    out.data_ptr(), nc, stream),
               "dequantize_int8")
    dequantize_launches += 1
    return out


def _check_codes(q: torch.Tensor, scales: torch.Tensor):
    if q.dtype != torch.int8 or q.dim() != 2 or q.shape[1] != INT8_CHUNK:
        raise ValueError(f"dequantize_int8: codes must be (n_chunks, "
                         f"{INT8_CHUNK}) int8, got {tuple(q.shape)} "
                         f"{q.dtype}")
    if scales.dtype != torch.float32 or scales.numel() != q.shape[0] \
            or scales.device != q.device:
        raise ValueError(f"dequantize_int8: scales must be {q.shape[0]} "
                         f"float32 values on {q.device}, got "
                         f"{tuple(scales.shape)} {scales.dtype} on "
                         f"{scales.device}")


def quantize_int8(x: torch.Tensor):
    """Chunked-int8 encode: any-shape float tensor -> ((n_chunks, 256)
    int8 codes, (n_chunks, 1) f32 scales); the kernel for a CUDA tensor,
    ``odc.quantize_chunked`` for a CPU tensor."""
    if x.device.type == "cpu":
        return odc.quantize_chunked(x)
    if x.device.type != "cuda" or not x.is_floating_point():
        raise ValueError(f"quantize_int8: a float tensor on cuda or cpu, "
                         f"not {x.dtype} on {x.device}")
    return _encode(_chunk_blocks(x))


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    """Invert ``quantize_int8`` back to a tensor of ``shape`` (padding
    dropped); the kernel for CUDA tensors, ``odc.dequantize_chunked`` for
    CPU tensors."""
    if q.device.type == "cpu":
        return odc.dequantize_chunked(q, scales, shape, dtype)
    _check_codes(q, scales)
    size = 1
    for s in shape:
        size *= s
    return _decode(q, scales).reshape(-1)[:size].reshape(shape).to(dtype)


def gather_codes(qs: Sequence[torch.Tensor], ss: Sequence[torch.Tensor],
                 order: Optional[Sequence[int]] = None, *,
                 blocks_per_rank: Optional[int] = None):
    """The compressed gather itself (``odc_gather_q8_pallas``): every
    rank's ``(n_chunks, 256)`` codes and ``(n_chunks, 1)`` scales -> per
    rank ``(n, n_chunks, 256)`` codes and ``(n, n_chunks, 1)`` scales, row
    s holding rank s's encoding as it left rank s.  One launch of the CUDA
    kernel for CUDA tensors: block (b, s) reads whole chunks of rank s's
    encoding once, codes and scales together, and stores them to row s of
    every output; it allocates nothing but the outputs and takes any grid
    (``blocks_per_rank``, default ``_ring.pull_blocks_per_rank`` of the
    codes).  For CPU tensors the plain ring moves the codes and scales as
    it moves any shard."""
    global gather_launches
    n = len(qs)
    nc = qs[0].shape[0]
    if qs[0].device.type == "cpu":
        q_out = odc.ring_gather(qs, order)
        s_out = odc.ring_gather(ss, order)
        return ([q.view(n, nc, INT8_CHUNK) for q in q_out],
                [s.view(n, nc, 1) for s in s_out])
    device = qs[0].device
    for q, s in zip(qs, ss):
        if q.dtype != torch.int8 or tuple(q.shape) != (nc, INT8_CHUNK) \
                or s.dtype != torch.float32 or s.numel() != nc \
                or q.device != device or s.device != device \
                or not (q.is_contiguous() and s.is_contiguous()):
            raise ValueError(f"gather_codes: every rank needs contiguous "
                             f"({nc}, {INT8_CHUNK}) int8 codes and {nc} "
                             f"float32 scales on {device}")
    _ring.order_table(n, order)  # the kernel needs none; a bad one raises
    lib = _build.library("odc_q8")
    if blocks_per_rank is None:
        with torch.cuda.device(device):
            cap = _ring.capacity(lib, "repro_odc_gather_q8_capacity")
        blocks_per_rank = _ring.pull_blocks_per_rank(
            nc * INT8_CHUNK, n, cap, _ring.BCAST_UNROLL)
    _ring.check_grid("gather_codes", blocks_per_rank)
    q_out = [torch.empty((n, nc, INT8_CHUNK), dtype=torch.int8,
                         device=device) for _ in range(n)]
    s_out = [torch.empty((n, nc, 1), dtype=torch.float32, device=device)
             for _ in range(n)]
    if nc:
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            _check(lib.repro_odc_gather_q8(
                _ring.pointers(qs), _ring.pointers(q_out),
                _ring.pointers(ss), _ring.pointers(s_out), n, nc,
                blocks_per_rank, stream), "odc_gather_q8")
        gather_launches += 1
    return q_out, s_out


def odc_gather_q8(shards: Sequence[torch.Tensor],
                  order: Optional[Sequence[int]] = None, *,
                  blocks_per_rank: Optional[int] = None
                  ) -> List[torch.Tensor]:
    """Every rank's (n*c, ...) full tensor from every rank's (c, ...)
    shard over the compressed wire: the kernels for CUDA tensors (n
    encodes, one gather launch, n decodes), ``odc.ring_gather_q8`` for CPU
    tensors.  ``blocks_per_rank`` overrides the gather's grid."""
    if shards[0].device.type == "cpu":
        return odc.ring_gather_q8(shards, order)
    _ring.check(shards, "odc_gather_q8")
    n = len(shards)
    x = shards[0]
    c, size = x.shape[0], x.numel()
    enc = [_encode(_chunk_blocks(s)) for s in shards]
    nc = enc[0][0].shape[0]
    q_out, s_out = gather_codes([q for q, _ in enc], [s for _, s in enc],
                                order, blocks_per_rank=blocks_per_rank)
    del enc
    outs = []
    for r in range(n):
        flat = _decode(q_out[r].view(n * nc, INT8_CHUNK),
                       s_out[r].view(n * nc, 1)).view(n, nc * INT8_CHUNK)
        full = flat[:, :size].reshape((n * c,) + tuple(x.shape[1:]))
        full = full.to(x.dtype)
        full[r * c:(r + 1) * c] = shards[r]  # the own shard lands exactly
        outs.append(full)
        q_out[r] = s_out[r] = None
    return outs


def odc_scatter_accumulate_q8(ys: Sequence[torch.Tensor],
                              order: Optional[Sequence[int]] = None, *,
                              blocks_per_rank: Optional[int] = None
                              ) -> List[torch.Tensor]:
    """Every rank's owned (c, ...) chunk summed over the ranks, every
    hop's partial sum requantized: the kernel for CUDA tensors,
    ``odc.ring_scatter_accumulate_q8`` for CPU tensors.
    ``blocks_per_rank`` overrides the ring's block count."""
    global scatter_launches
    if ys[0].device.type == "cpu":
        return odc.ring_scatter_accumulate_q8(ys, order)
    device = _ring.check(ys, "odc_scatter_accumulate_q8")
    n = len(ys)
    y = ys[0]
    if y.dim() == 0 or y.shape[0] % n:
        raise ValueError(f"odc_scatter_accumulate_q8: leading dim of "
                         f"{tuple(y.shape)} is not a multiple of {n} ranks")
    c, csize = y.shape[0] // n, y.numel() // n
    pad = (-csize) % INT8_CHUNK
    nc = (csize + pad) // INT8_CHUNK
    ins = []
    for t in ys:  # per destination chunk, zero-padded to whole chunks
        flat = t.reshape(n, csize).to(torch.float32)
        if pad:
            flat = torch.cat([flat, flat.new_zeros(n, pad)], dim=1)
        ins.append(_aligned(flat))
    lib = _build.library("odc_q8")
    with torch.cuda.device(device):
        cap = _ring.capacity(lib, "repro_odc_scatter_q8_capacity")
    if blocks_per_rank is None:
        blocks_per_rank = _ring.blocks_per_rank(nc * INT8_CHUNK * 4, n, cap)
    outs = [torch.empty((nc, INT8_CHUNK), dtype=torch.float32,
                        device=device) for _ in range(n)]
    stages = [torch.empty(2 * nc * (INT8_CHUNK + 4), dtype=torch.uint8,
                          device=device) for _ in range(n)]
    if nc:
        _ring.launch(lib.repro_odc_scatter_q8, "odc_scatter_accumulate_q8",
                     ins, outs, stages, order, nc, 0, blocks_per_rank, cap,
                     _SCATTER_STATE, device)
        scatter_launches += 1
    return [o.reshape(-1)[:csize].reshape((c,) + tuple(y.shape[1:]))
            .to(y.dtype) for o in outs]
