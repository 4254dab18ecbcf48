"""Karmarkar–Karp (largest differencing method) number partitioning.

Used by every load-balancing strategy in the paper (Appendix C): split a
list of per-sample compute costs into k partitions minimizing the maximum
partition sum.  ``equal_size=True`` additionally forces equal sample counts
per partition (the verl constraint the paper relaxes for ODC+LB-Mini).
"""
from __future__ import annotations

import heapq
from typing import List, Sequence, Tuple


def karmarkar_karp(compute_costs: Sequence[float], k_partitions: int,
                   equal_size: bool = False) -> List[List[int]]:
    """Returns k lists of *indices* into compute_costs.

    Classic LDM: maintain a heap of partial solutions keyed by the spread
    (max-sum − min-sum); repeatedly merge the two with largest spread by
    pairing the largest-sum side of one with the smallest-sum side of the
    other.  ``equal_size`` keys merges to also balance counts (merging is
    only valid between solutions whose counts allow an even split).
    """
    k = int(k_partitions)
    n = len(compute_costs)
    if k <= 0:
        raise ValueError("k_partitions must be positive")
    if n == 0:
        return [[] for _ in range(k)]  # an empty wave still needs k slots
    if k == 1:
        return [list(range(n))]

    # each heap entry: (-spread, tiebreak, sums, counts, partitions)
    # sums ascending; partitions aligned with sums.
    heap = []
    for i, c in enumerate(compute_costs):
        sums = [0.0] * (k - 1) + [float(c)]
        counts = [0] * (k - 1) + [1]
        parts: List[List[int]] = [[] for _ in range(k - 1)] + [[i]]
        heapq.heappush(heap, (-(sums[-1] - sums[0]), i, sums, counts, parts))

    tiebreak = n
    while len(heap) > 1:
        _, _, s1, c1, p1 = heapq.heappop(heap)
        _, _, s2, c2, p2 = heapq.heappop(heap)
        # merge: largest of one with smallest of the other
        merged = [
            (s1[j] + s2[k - 1 - j], c1[j] + c2[k - 1 - j], p1[j] + p2[k - 1 - j])
            for j in range(k)
        ]
        if equal_size:
            # sort by (count, sum) so counts stay balanced as we merge
            merged.sort(key=lambda t: (t[1], t[0]))
        else:
            merged.sort(key=lambda t: t[0])
        sums = [m[0] for m in merged]
        counts = [m[1] for m in merged]
        parts = [m[2] for m in merged]
        tiebreak += 1
        heapq.heappush(
            heap, (-(sums[-1] - sums[0]), tiebreak, sums, counts, parts))

    _, _, sums, counts, parts = heap[0]
    return parts


def partition_sums(compute_costs: Sequence[float],
                   partitions: Sequence[Sequence[int]]) -> List[float]:
    return [sum(compute_costs[i] for i in p) for p in partitions]


def imbalance(compute_costs: Sequence[float],
              partitions: Sequence[Sequence[int]]) -> float:
    """max/mean partition cost − 1 (0 = perfectly balanced)."""
    sums = partition_sums(compute_costs, partitions)
    mean = sum(sums) / max(len(sums), 1)
    return (max(sums) / mean - 1.0) if mean > 0 else 0.0
