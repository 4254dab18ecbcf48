"""The ranks of the data axis, held by one controller.

The JAX engine runs one program over every rank (``shard_map`` over the
mesh's data axis, ``repro.launch.mesh.make_host_mesh``).  The port does
the same with a ``RankGroup``: one process holds n ranks, each with the
``torch.device`` its shards and activations live on, and every collective
step (a ring gather, a scatter-accumulate, a sum over ranks) is one call
that sees all ranks at once.  On one card every rank is ``cuda:0``, so a
ring kernel is one launch that runs every rank's side of every hop; in
the tests every rank is ``cpu``.

Why not one process per rank: at world size 1 both rings do nothing, so a
one-card run must hold several ranks; NCCL refuses two ranks on one GPU,
and kernels of separate processes are time-sliced on a GPU, so a ring
whose hops wait on each other across processes would crawl or hang.
Ranks on separate cards are a later slice (ROADMAP.md queue 1 item 9).

Context parallelism lays the ranks out as (data, cp), the counterpart of
``repro.launch.mesh.make_cp_mesh``: rank ``d*cp + c`` is position c of
group d, a group is cp adjacent ranks (the cp axis minor), and
parameters stay sharded over the flat ``data*cp`` ranks, as under flat
ODC at the same world size (``cp_groups``).

The two-tier backends (``hier``, ``pipe``, ``pipe-int8``) lay the ranks
out as (inter, intra), the counterpart of ``repro.launch.mesh.
make_hier_mesh`` (node, device) and ``make_pipe_mesh`` (pipe, data):
rank ``t*intra + d`` is device d of group t, node-major as the meshes'
reshape (``Tiers``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch


def cp_groups(n: int, cp: int) -> List[range]:
    """The cp groups of n ranks: ``range(d*cp, (d+1)*cp)`` for each data
    index d."""
    if cp < 1 or n % cp:
        raise ValueError(f"{n} ranks do not split into groups of cp={cp}")
    return [range(d * cp, (d + 1) * cp) for d in range(n // cp)]


@dataclasses.dataclass(frozen=True)
class Tiers:
    """A two-tier layout of ``inter * intra`` ranks: ``inter`` groups
    (nodes, or pipeline stages) of ``intra`` ranks each, rank
    ``t*intra + d`` being device d of group t."""

    inter: int
    intra: int

    @classmethod
    def split(cls, n: int, inter: int) -> "Tiers":
        """n ranks in ``inter`` groups; raises when they do not split."""
        if inter < 1 or n % inter:
            raise ValueError(f"{n} ranks do not split into {inter} groups "
                             f"(nodes or pipeline stages) of equal size")
        return cls(inter, n // inter)

    @property
    def n(self) -> int:
        return self.inter * self.intra

    def intra_groups(self) -> List[range]:
        """The ranks of each group (a node's devices, a stage's ranks)."""
        return [range(t * self.intra, (t + 1) * self.intra)
                for t in range(self.inter)]

    def inter_rings(self) -> List[List[int]]:
        """The ranks of each device index across the groups, in group
        order: the inter tier's rings."""
        return [[t * self.intra + d for t in range(self.inter)]
                for d in range(self.intra)]


@dataclasses.dataclass(frozen=True)
class RankGroup:
    devices: Tuple[torch.device, ...]

    @property
    def n(self) -> int:
        return len(self.devices)

    @classmethod
    def make(cls, n: int = 0, device: str = "cuda") -> "RankGroup":
        """n ranks on ``device`` ('cuda' or 'cpu'); n = 0 means one rank
        per visible device.  Every CUDA rank lies on the current card, so
        n = 0 with more than one visible card raises: ranks on separate
        cards are not yet ported."""
        if device == "cpu":
            return cls(tuple(torch.device("cpu") for _ in range(max(n, 1))))
        if device != "cuda":
            raise ValueError(f"device must be 'cuda' or 'cpu', not "
                             f"{device!r}")
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' but torch finds no CUDA "
                               "device; pass --device cpu to run on the CPU")
        if n <= 0:
            n = torch.cuda.device_count()
            if n > 1:
                raise NotImplementedError(
                    f"one rank per visible device would spread {n} ranks "
                    f"over {n} cards, and ranks on separate cards are not "
                    f"yet ported (ROADMAP.md queue 1 item 9); pass a rank "
                    f"count to hold that many ranks on the current card")
        dev = torch.device("cuda", torch.cuda.current_device())
        return cls(tuple(dev for _ in range(n)))
