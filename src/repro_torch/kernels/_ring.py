"""What the ODC ring kernels' wrappers share: input checks, the block
count and grid plans, the device-side flag state of the q8 scatter's
ring, the launch plan of the chained rings, the launches through
``ctypes``, and the per-layer signals between a chained ring on a side
stream and the compute stream (the driver's stream memory operations).

Every rank of the ring lies on one card in this version, so one launch
serves every rank.  The single-leaf gathers (``odc_gather.odc_gather``,
``quant.gather_codes``) and the single-leaf scatter
(``odc_scatter.odc_scatter_accumulate``) have no hops: each source shard
is read once and broadcast to its row of every output
(``csrc/odc_bcast.cuh``), and each owner pulls every contribution to its
chunk, through the pointer table, with no state between calls.  Their
default grid is ``pull_blocks_per_rank``.  The q8 scatter alone still
signals its hops through flags and credits in device buffers owned by a
``RingState`` (one per device), never reset: each call reads its epoch
from a device counter that the wrapper advances after the launch (see
``csrc/odc_ring.cuh``).
A chained ring is a cluster kernel (``csrc/odc_cluster.cuh``): cluster b
holds slice b of every layer for all n ranks, its hops move tiles from
one block's shared memory into its right neighbour's under mbarriers,
and nothing but the outputs lives in device memory, so a chained launch
has no state between calls.  Its launch plan (``chain_plan``: tile size,
slots, shared memory, slice and grid) is a pure function of c, the
element size, n and the card's co-resident clusters, which the CPU tests
check.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Sequence

import torch

MAX_RANKS = 16
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# bytes of a shard that one block carries, at least
BYTES_PER_BLOCK = 1 << 16
# cudaErrorCooperativeLaunchTooLarge
TOO_LARGE = 720
# The pull kernels (odc_bcast.cuh's broadcast for rows 1 and 9,
# odc_scatter.cu's pull for row 3): threads of a block, and the default
# grid's waves of resident blocks.  Blocks are scheduled source by source
# (owner by owner), so two waves let the first read half the shards, and
# the DRAM sees half as many streams at once (measured a little faster
# than one wave for the scatter on an H100).  The gathers keep two waves
# on purpose: on an H100 eight were 5% faster at qwen's w_up shard on 2
# ranks and 5% slower at 2**24 on 4 (chip_smoke.py's times phase sweeps
# them)
PULL_THREADS = 256
PULL_WAVES = 2
# 16-byte vectors a thread of the broadcast holds between its load and its
# n stores (ODC_BCAST_UNROLL)
BCAST_UNROLL = 4
# A chained ring (odc_gather_layers, odc_scatter_accumulate_layers) runs
# beside the compute kernels of a training step, so its grid takes at most
# 1/CHAIN_SHARE of the blocks the card can hold at once (all ranks
# together, counted in the chained kernel's own blocks), and a single-leaf
# ring takes at most 1 - 2/CHAIN_SHARE of its own: either grid can be
# resident while the other runs.
CHAIN_SHARE = 16


def check(tensors: Sequence[torch.Tensor], what: str) -> torch.device:
    """The one device (CUDA, or the CPU of a plain route) that every rank's
    tensor lies on; raises on anything the kernels do not take."""
    n = len(tensors)
    if not 1 <= n <= MAX_RANKS:
        raise ValueError(f"{what}: {n} ranks, the kernel takes 1..{MAX_RANKS}")
    t0 = tensors[0]
    if t0.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: runs on cuda or cpu, not {t0.device}")
    if t0.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {t0.dtype} is not float32 or "
                        f"bfloat16")
    for t in tensors:
        if t.device != t0.device:
            raise NotImplementedError(
                f"{what}: ranks on {t0.device} and {t.device}; rings across "
                f"cards are not yet ported (ROADMAP.md queue 1 item 9), "
                f"every rank must lie on one card")
        if t.dtype != t0.dtype or t.shape != t0.shape:
            raise ValueError(f"{what}: every rank needs the same shape and "
                             f"dtype, got {tuple(t0.shape)} {t0.dtype} and "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    return t0.device


def check_out(out: Sequence[torch.Tensor], like: torch.Tensor, shape,
              what: str):
    """Raises unless every tensor of ``out`` is contiguous, of this shape,
    and of ``like``'s dtype and device."""
    for o in out:
        if tuple(o.shape) != tuple(shape) or o.dtype != like.dtype \
                or o.device != like.device or not o.is_contiguous():
            raise ValueError(f"{what}: out must be contiguous {tuple(shape)} "
                             f"{like.dtype} on {like.device}, got "
                             f"{tuple(o.shape)} {o.dtype} on {o.device}")


def order_table(n: int, order: Optional[Sequence[int]]):
    """ctypes int array of the ring order (position -> rank)."""
    order = list(range(n)) if order is None else [int(r) for r in order]
    if sorted(order) != list(range(n)):
        raise ValueError(f"ring order {order} is not a permutation of "
                         f"range({n})")
    return (ctypes.c_int * n)(*order)


def pointers(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


class RingState:
    """Flags, credits and the epoch counter of one single-leaf ring kernel
    on one device, grown as a launch needs more blocks."""

    def __init__(self):
        self._by_device = {}

    def get(self, device: torch.device, n: int, blocks: int):
        flags, credits, epoch = self._by_device.get(
            device, (None, None, None))
        if flags is None or flags.numel() < n * 2 * blocks:
            # zeros are below every tag, and the epoch keeps counting up
            flags = torch.zeros(MAX_RANKS * 2 * blocks, dtype=torch.int32,
                                device=device)
            credits = torch.zeros(MAX_RANKS * blocks, dtype=torch.int32,
                                  device=device)
            if epoch is None:
                epoch = torch.zeros(1, dtype=torch.int64, device=device)
            self._by_device[device] = (flags, credits, epoch)
        return flags, credits, epoch


_capacities: dict = {}


def capacity(lib, symbol: str, *args) -> int:
    """Blocks (or clusters) of this kernel that the current card can hold
    at once, asked of the card once per device and arguments."""
    key = (symbol, args, torch.cuda.current_device())
    if key not in _capacities:
        out = ctypes.c_int(0)
        err = getattr(lib, symbol)(*args, ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"{symbol} failed: CUDA error {err}")
        _capacities[key] = out.value
    return _capacities[key]


def pull_blocks_per_rank(nbytes: int, n: int, cap: int, unroll: int,
                         waves: int = PULL_WAVES) -> int:
    """The default grid of a pull kernel, in blocks for each of the n
    sources (owners) of ``nbytes`` bytes: enough for every thread to hold
    ``unroll`` 16-byte vectors, at most ``waves`` times as many as the
    card holds at once over all n (``cap``), at least one."""
    vectors = -(-nbytes // 16)
    want = max(1, -(-vectors // (PULL_THREADS * unroll)))
    return max(1, min(want, waves * cap // n))


def check_grid(name: str, blocks: int):
    """Raises unless a pull kernel can launch ``blocks`` blocks a rank."""
    if not 1 <= blocks < 2 ** 31:
        raise ValueError(f"{name}: blocks_per_rank {blocks} is not in "
                         f"[1, 2**31)")


def blocks_per_rank(nbytes: int, n: int, cap: int) -> int:
    """Blocks for each rank of a single-leaf ring: one per
    ``BYTES_PER_BLOCK`` of the shard, as many as fit on the card at once
    with every rank's blocks resident and room left for a chained ring."""
    want = max(1, -(-nbytes // BYTES_PER_BLOCK))
    return max(1, min(want, (cap - 2 * (cap // CHAIN_SHARE)) // n))


def chain_blocks_per_rank(nbytes: int, n: int, cap: int) -> int:
    """Blocks for each rank of a chained ring (clusters): one per
    ``BYTES_PER_BLOCK`` of a layer's shard, at most 1/CHAIN_SHARE of the
    card's co-resident blocks over all ranks."""
    want = max(1, -(-nbytes // BYTES_PER_BLOCK))
    return max(1, min(want, (cap // CHAIN_SHARE) // n))


def refuse(name: str, n: int, blocks: int, cap: int, device):
    raise RuntimeError(
        f"{name}: {n} ranks x {blocks} blocks cannot all be resident on "
        f"{device} at once ({cap} can; the blocks wait on each other); "
        f"launch refused")


def launch(fn, name: str, ins, outs, stages, order, elems: int, code: int,
           blocks: int, cap: int, state: RingState, device: torch.device,
           extra=()):
    """Launch the single-leaf ring ``fn`` on the current stream; raises on
    a refused launch, before anything ran.  ``cap`` is the card's
    co-resident block count for this kernel; the C side checks it too.
    The kernel reads its epoch from the device counter, which is advanced
    after the launch.  ``extra`` are the arguments after the epoch, before
    the stream."""
    n = len(ins)
    if n * blocks > cap:
        refuse(name, n, blocks, cap, device)
    flags, credits, epoch = state.get(device, n, blocks)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(pointers(ins), pointers(outs), pointers(stages),
                 order_table(n, order), n, elems, code, blocks,
                 flags.data_ptr(), credits.data_ptr(), epoch.data_ptr(),
                 *extra, stream)
    if err == TOO_LARGE:
        refuse(name, n, blocks, cap, device)
    if err != 0:
        raise RuntimeError(f"{name} kernel failed to launch: CUDA error "
                           f"{err}")
    epoch.add_(1)


# ---------------------------------------------------------------------------
# the chained rings' launch plan (cluster kernels, csrc/odc_cluster.cuh)
# ---------------------------------------------------------------------------
# shared memory of one H100 SM, of which the runtime reserves 1 KB for each
# resident block
SM_SHARED_BYTES = 233_472
BLOCK_RESERVED_BYTES = 1024
# A chained kernel's shared memory is sized so that this many of its blocks
# fit on one SM; its grid share (CHAIN_SHARE) then spreads over about
# 8/CHAIN_SHARE of the SMs, one block on each.
CHAIN_BLOCKS_PER_SM = 8
# Own slots (TMA loads), first slots (the scatter's hop-1 tiles, loaded
# and pushed as they are) and recv slots per ring (each hop gets
# max(1, this // (n - 1)) of its own) of each chained kernel.  A bulk copy
# costs a few hundred nanoseconds whatever its size, so a few large slots
# move more than many small ones in the same shared memory (PERF.md §6).
CHAIN_KERNELS = {"gather": (3, 0, 2), "scatter": (4, 1, 1)}


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """What a chained launch passes its kernel besides the tensors."""
    own_slots: int
    first_slots: int
    recv_depth: int        # recv slots of each hop
    tile_bytes: int        # bytes of one slot, a multiple of 128
    smem_bytes: int        # dynamic shared memory of one block
    slice_elems: int = 0   # elements of c per cluster, 16-byte multiple
    blocks_per_rank: int = 0  # clusters


def chain_smem_bytes(n: int, tile_bytes: int, own: int, first: int,
                     depth: int) -> int:
    """A block's shared memory: the slots, a full and an empty (or rfree)
    barrier for each, and a third barrier for each own slot
    (odc_chain_smem_bytes)."""
    slots = own + first + (depth * (n - 1) if n > 1 else 0)
    return slots * (tile_bytes + 16) + 8 * own


def chain_layout(kind: str, n: int) -> ChainPlan:
    """Slots, tile size and shared memory of a chained kernel ("gather"
    or "scatter") on n ranks, for any c and element size."""
    own, first, recv = CHAIN_KERNELS[kind]
    depth = max(1, recv // max(1, n - 1))
    budget = SM_SHARED_BYTES // CHAIN_BLOCKS_PER_SM - BLOCK_RESERVED_BYTES
    slots = own + first + (depth * (n - 1) if n > 1 else 0)
    tile = (budget - chain_smem_bytes(n, 0, own, first, depth)) // slots
    tile -= tile % 128
    return ChainPlan(own, first, depth, tile,
                     chain_smem_bytes(n, tile, own, first, depth))


def chain_plan(kind: str, c: int, elem_bytes: int, n: int, clusters: int,
               blocks_per_rank: Optional[int] = None) -> ChainPlan:
    """The launch plan of a chained ring over n ranks' layers of c
    elements of ``elem_bytes``, on a card that holds ``clusters`` clusters
    of this kernel at once: the layout, the grid (at most 1/CHAIN_SHARE of
    the card unless ``blocks_per_rank`` overrides it) and the slice of c
    each cluster carries, cut at 16 bytes so that every tile starts
    aligned.  Raises when the card cannot hold one cluster."""
    lay = chain_layout(kind, n)
    if clusters < 1:
        raise RuntimeError(
            f"odc chained {kind}: the card cannot hold one cluster of {n} "
            f"blocks of {lay.smem_bytes} bytes of shared memory each, so no "
            f"grid of it can be resident; launch refused")
    if blocks_per_rank is None:
        blocks_per_rank = chain_blocks_per_rank(c * elem_bytes, n,
                                                clusters * n)
    step = 16 // math.gcd(16, elem_bytes)
    per = -(-max(c, 1) // blocks_per_rank)
    return dataclasses.replace(lay, slice_elems=-(-per // step) * step,
                               blocks_per_rank=blocks_per_rank)


def chain_launch(fn, name: str, ins, outs, order, elems: int, code: int,
                 layers: int, plan: ChainPlan, clusters: int,
                 device: torch.device, extra=()):
    """Launch the chained ring ``fn`` with ``plan`` on the current stream;
    raises on a refused launch (a grid of more clusters than the card
    holds at once), before anything ran.  ``extra`` are the arguments
    after the grid, before the stream."""
    n = len(ins)
    if plan.blocks_per_rank > clusters:
        refuse(name, n, plan.blocks_per_rank, clusters * n, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(pointers(ins), pointers(outs), order_table(n, order), n,
                 elems, code, layers, plan.slice_elems, plan.tile_bytes,
                 plan.own_slots, plan.first_slots, plan.recv_depth,
                 plan.blocks_per_rank, *extra, stream)
    if err == TOO_LARGE:
        refuse(name, n, plan.blocks_per_rank, clusters * n, device)
    if err != 0:
        raise RuntimeError(f"{name} kernel failed to launch: CUDA error "
                           f"{err}")


# ---------------------------------------------------------------------------
# per-layer signals between a chained ring and the compute stream
# ---------------------------------------------------------------------------
_cu = None
_MEMOPS = ("cuStreamWaitValue32_v2", "cuStreamWriteValue32_v2")


def _driver():
    """The CUDA driver library, with its stream memory operations typed:
    fn(stream, address, value, flags) -> CUresult.  Raises when the
    driver lacks them."""
    global _cu
    if _cu is None:
        lib = ctypes.CDLL("libcuda.so.1")
        for symbol in _MEMOPS:
            if not hasattr(lib, symbol):
                raise RuntimeError(
                    f"the CUDA driver has no {symbol}: the overlap schedule "
                    f"needs stream memory operations")
            fn = getattr(lib, symbol)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32,
                           ctypes.c_uint]
            fn.restype = ctypes.c_int
        _cu = lib
    return _cu


def _memop(symbol: str, stream, address: int, value: int):
    err = getattr(_driver(), symbol)(stream, address, value & 0xFFFFFFFF, 0)
    if err != 0:
        raise RuntimeError(
            f"{symbol} failed with CUresult {err}: the card refuses stream "
            f"memory operations, which the overlap schedule needs")


def stream_wait(address: int, value: int, stream=None):
    """The stream (default: the current one) waits until the 32-bit word
    at ``address`` has reached ``value`` in cyclic order
    (CU_STREAM_WAIT_VALUE_GEQ)."""
    stream = stream or torch.cuda.current_stream()
    _memop(_MEMOPS[0], stream.cuda_stream, address, value)


def stream_write(address: int, value: int, stream=None):
    """The stream writes ``value`` to the 32-bit word at ``address`` once
    its earlier work is done, behind a memory barrier
    (CU_STREAM_WRITE_VALUE_DEFAULT)."""
    stream = stream or torch.cuda.current_stream()
    _memop(_MEMOPS[1], stream.cuda_stream, address, value)


def probe_stream_memops(device: torch.device):
    """Write and wait on a scratch word once, so that a card or driver
    that refuses stream memory operations raises before any work of the
    overlap schedule is enqueued."""
    word = torch.zeros(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream_write(word.data_ptr(), 1)
        stream_wait(word.data_ptr(), 1)
        torch.cuda.current_stream(device).synchronize()
    if int(word.item()) != 1:
        raise RuntimeError("stream memory operations did not write their "
                           "word on this card")


class LayerDone:
    """Per-layer completion counters of the chained gathers on one device.
    Every storing thread of a launch (n in each of its blocks) adds one to
    ``done[l]`` once its stores of layer l are complete; the counters are
    never reset, and the host keeps
    their running total, so ``wait(l)`` makes the current stream wait for
    layer l of the latest launch exactly.  On the CPU it does nothing:
    the plain rings are done when they return."""

    def __init__(self, layers: int, device: torch.device):
        self.device = torch.device(device)
        self.words = (torch.zeros(layers, dtype=torch.int32, device=device)
                      if self.device.type == "cuda" else None)
        self.target = 0

    def advance(self, adds: int):
        """A launch whose threads add ``adds`` to each word is enqueued."""
        self.target = (self.target + adds) & 0xFFFFFFFF

    def wait(self, layer: int, stream=None):
        if self.words is not None:
            stream_wait(self.words[layer].data_ptr(), self.target, stream)


class LayerReady:
    """Per-layer ready flags of the chained scatters on one device:
    ``arm()`` starts a round with a value above the last round's (cyclic,
    so the words are never reset); the compute stream's ``set(l)`` writes
    that value once layer l's contributions are in place, and the blocks
    of the round's scatter launch wait for it before layer l's first hop.
    On the CPU it does nothing."""

    def __init__(self, layers: int, device: torch.device):
        self.device = torch.device(device)
        self.words = (torch.zeros(layers, dtype=torch.int32, device=device)
                      if self.device.type == "cuda" else None)
        self.value = 0

    def arm(self) -> int:
        self.value = (self.value + 1) & 0xFFFFFFFF
        return self.value

    def set(self, layer: int, stream=None):
        if self.words is not None:
            stream_write(self.words[layer].data_ptr(), self.value, stream)
