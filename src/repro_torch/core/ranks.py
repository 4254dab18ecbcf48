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
Ranks on separate cards are a later slice (ROADMAP §0).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


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
                    f"yet ported (ROADMAP §0); pass a rank count to hold "
                    f"that many ranks on the current card")
        dev = torch.device("cuda", torch.cuda.current_device())
        return cls(tuple(dev for _ in range(n)))
