"""Rollout dispatch queue with a bounded-staleness contract.

The decoupling point of the asynchronous post-training pipeline: rollout
workers ``put`` variable-length rollouts as they finish (tagged with the
weight version they were generated under), and the trainer ``pop``s a
minibatch's worth as soon as enough have landed — instead of idling
through the whole generation wave.

Invariants (a copy of ``repro.posttrain.buffer``, held to it by
``tests/test_torch_posttrain.py``):

  * **FIFO** — rollouts leave in arrival order, always; async dispatch
    reorders *phases*, never samples, so staleness-0 is bit-identical to
    the synchronous alternating loop.
  * **staleness bound** — ``pop(n, train_step=t)`` refuses to hand out a
    rollout generated under weight version ``v < t - staleness``; the
    pipeline must re-generate (or have pushed weights in time).  The
    observed staleness of every dispatched rollout is recorded in
    ``staleness_seen``.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Deque, List, Optional

import numpy as np


class StalenessViolation(RuntimeError):
    """A rollout older than the staleness bound reached the trainer."""


@dataclasses.dataclass
class Rollout:
    """One variable-length rollout with its training weight."""

    tokens: np.ndarray           # (length,) int32
    advantage: Optional[float]   # None for SFT samples (unit weight)
    version: int                 # trainer step count when generated
    seq: int = -1                # arrival index, assigned by the buffer

    @property
    def length(self) -> int:
        return int(len(self.tokens))


class RolloutBuffer:
    """FIFO queue of rollouts with a configurable staleness bound."""

    def __init__(self, staleness: int = 0):
        if staleness < 0:
            raise ValueError(f"staleness bound must be >= 0, got {staleness}")
        self.staleness = staleness
        self._q: Deque[Rollout] = deque()
        self._arrivals = 0
        #: observed (train_step - version) of every dispatched rollout
        self.staleness_seen: List[int] = []

    def __len__(self) -> int:
        return len(self._q)

    def put(self, rollouts, version: Optional[int] = None):
        """Enqueue finished rollouts (arrival order = dispatch order).

        A ``Rollout``'s own ``version`` tag is trusted; passing a
        conflicting wave-level ``version`` is an error (one source of
        truth for the staleness accounting).  Raw token arrays are
        wrapped and need the ``version`` argument.

        The whole batch is validated BEFORE anything is enqueued — like
        ``pop``, a rejected ``put`` must leave the queue intact so the
        caller can fix the wave and retry without half of it already
        dispatched to the trainer."""
        wrapped = []
        for i, r in enumerate(rollouts):
            if not isinstance(r, Rollout):
                if version is None:
                    raise ValueError("raw rollouts need a weight version")
                r = Rollout(tokens=np.asarray(r, np.int32), advantage=None,
                            version=version)
            elif version is not None and r.version != version:
                raise ValueError(
                    f"rollout #{self._arrivals + i} tagged version "
                    f"{r.version} conflicts with put(version={version})")
            wrapped.append(r)
        for r in wrapped:
            r.seq = self._arrivals
            self._arrivals += 1
            self._q.append(r)

    def ready(self, n: int) -> bool:
        return len(self._q) >= n

    def pop(self, n: int, *, train_step: int) -> List[Rollout]:
        """The oldest ``n`` rollouts, for training step ``train_step``.

        Raises ``StalenessViolation`` if any of them was generated under a
        weight version older than ``train_step - staleness`` — the
        pipeline's scheduling must make that impossible; the buffer is the
        enforcement point, not the scheduler.
        """
        if not self.ready(n):
            raise ValueError(
                f"buffer holds {len(self._q)} rollouts, minibatch needs {n}")
        floor = train_step - self.staleness
        head = list(itertools.islice(self._q, n))
        for r in head:  # validate BEFORE mutating: a violation must leave
            if r.version < floor:  # the queue intact for re-push + retry
                raise StalenessViolation(
                    f"rollout #{r.seq} generated at version {r.version} "
                    f"dispatched to train step {train_step} exceeds the "
                    f"staleness bound {self.staleness}")
        for r in head:
            self._q.popleft()
            self.staleness_seen.append(train_step - r.version)
        return head

    @property
    def max_staleness_seen(self) -> int:
        return max(self.staleness_seen, default=0)
