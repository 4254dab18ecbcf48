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
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch


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
