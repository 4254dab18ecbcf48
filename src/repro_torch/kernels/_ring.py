"""What the two ODC ring kernels' wrappers share: input checks, the block
count, the device-side flag state and the launch through ``ctypes``.

Every rank of the ring lies on one card in this version, so one launch
runs every rank's side of every hop.  The flags and credits that the
kernel's hops signal through live in device buffers owned by a
``RingState`` (one per kernel and device) and are never reset: each call
reads its epoch from a device counter that the wrapper advances after the
launch (see ``csrc/odc_ring.cuh``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

MAX_RANKS = 16
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# bytes of a shard that one block carries, at least
BYTES_PER_BLOCK = 1 << 16
# cudaErrorCooperativeLaunchTooLarge
TOO_LARGE = 720


def check(tensors: Sequence[torch.Tensor], what: str) -> torch.device:
    """The one CUDA device that every rank's tensor lies on; raises on
    anything the kernels do not take."""
    n = len(tensors)
    if not 1 <= n <= MAX_RANKS:
        raise ValueError(f"{what}: {n} ranks, the kernel takes 1..{MAX_RANKS}")
    t0 = tensors[0]
    if t0.device.type != "cuda":
        raise ValueError(f"{what}: runs on cuda or cpu, not {t0.device}")
    if t0.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {t0.dtype} is not float32 or "
                        f"bfloat16")
    for t in tensors:
        if t.device != t0.device:
            raise NotImplementedError(
                f"{what}: ranks on {t0.device} and {t.device}; rings across "
                f"cards are not yet ported (ROADMAP §0), every rank must lie "
                f"on one card")
        if t.dtype != t0.dtype or t.shape != t0.shape:
            raise ValueError(f"{what}: every rank needs the same shape and "
                             f"dtype, got {tuple(t0.shape)} {t0.dtype} and "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    return t0.device


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
    """Flags, credits and the epoch counter of one ring kernel on one
    device, grown as a launch needs more blocks."""

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


def capacity(lib, symbol: str, *args) -> int:
    """Blocks of this kernel that the card can hold at once."""
    out = ctypes.c_int(0)
    err = getattr(lib, symbol)(*args, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")
    return out.value


def blocks_per_rank(nbytes: int, n: int, cap: int) -> int:
    """Blocks for each rank: one per ``BYTES_PER_BLOCK`` of the shard, as
    many as fit on the card at once with every rank's blocks resident."""
    want = max(1, -(-nbytes // BYTES_PER_BLOCK))
    return max(1, min(want, cap // n))


def refuse(name: str, n: int, blocks: int, cap: int, device):
    raise RuntimeError(
        f"{name}: {n} ranks x {blocks} blocks cannot all be resident on "
        f"{device} at once ({cap} can; the blocks wait on each other); "
        f"launch refused")


def launch(fn, name: str, ins, outs, stages, order, elems: int, code: int,
           blocks: int, cap: int, state: RingState, device: torch.device):
    """Launch ``fn`` on the current stream and advance the epoch; raises
    on a refused launch, before anything ran.  ``cap`` is the card's
    co-resident block count for this kernel; the C side checks it too."""
    n = len(ins)
    if n * blocks > cap:
        refuse(name, n, blocks, cap, device)
    flags, credits, epoch = state.get(device, n, blocks)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(pointers(ins), pointers(outs), pointers(stages),
                 order_table(n, order), n, elems, code, blocks,
                 flags.data_ptr(), credits.data_ptr(), epoch.data_ptr(),
                 stream)
    if err == TOO_LARGE:
        refuse(name, n, blocks, cap, device)
    if err != 0:
        raise RuntimeError(f"{name} kernel failed to launch: CUDA error "
                           f"{err}")
    epoch.add_(1)
