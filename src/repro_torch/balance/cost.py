"""Workload cost + memory model for sequence batching (paper §2.2/§4).

For a sample of sequence length ``s`` on a transformer:

  compute  ≈ a·s + b·s²   (linear MLP/projections + quadratic attention)
  memory   ≈ m·s          (activations are linear in s)

The paper's central observation is the mismatch between the two: packing can
equalize *memory* (token counts) but not *compute* whenever a long sample's
quadratic cost exceeds any combination of short ones that fits in memory.

For attention-free (SSM) or sliding-window layers the quadratic term is
replaced by the appropriate sub-quadratic law, which is why the predicted
ODC gains shrink for those families (DESIGN.md §Arch-applicability).

Heterogeneity: ``DeviceProfile`` extends the model with per-device relative
speed (mixed-generation accelerators, thermal throttling), per-device wire
multipliers, and an optional stochastic per-step slowdown (seeded, so every
consumer — balancer, simulator, benchmark sweep — sees the same draw).  A
sample's *time* on device d is ``cost / speeds[d]``; balancing minimizes the
max of those normalized loads, not the max raw cost (cf. Zeppelin
arXiv:2509.21841, WLB-LLM arXiv:2503.17924: balance must fold in
device-side variance, not just sequence-length variance).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Per-token linear and per-token² attention coefficients.

    Defaults follow the paper's regime: cost normalized so a 1-token sample
    costs ~1; quadratic term calibrated so attention ≈ linear cost at
    ``balance_point`` tokens (for LLM post-training with seq up to 64k the
    attention share is large).
    """

    linear_coef: float = 1.0
    quad_coef: float = 1.0 / 4096.0  # attention == linear cost at 4k tokens
    window: int = 0       # >0: sliding-window attention (cost a·s + b·s·w)
    attention_free: bool = False  # SSM: pure linear

    def sample_cost(self, s: int) -> float:
        if self.attention_free:
            return self.linear_coef * s
        if self.window and s > self.window:
            return self.linear_coef * s + self.quad_coef * s * self.window
        return self.linear_coef * s + self.quad_coef * s * s

    def costs(self, seqlens: Sequence[int]) -> List[float]:
        return [self.sample_cost(int(s)) for s in seqlens]


DEFAULT_COST_MODEL = CostModel()


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Per-device speed / straggler model.

    speeds      relative compute throughput per device (1.0 = nominal,
                0.5 = a straggler at half speed); a sample of cost c takes
                c / speeds[d] time units on device d.
    comm_scale  per-device wire-time multiplier (1.0 = nominal, 2.0 = a
                device behind a congested NIC pays 2x per transfer).
                Empty tuple means all-ones.
    jitter      sigma of a multiplicative lognormal per-step slowdown
                applied to both compute and wire time (0 = deterministic).
    seed        base seed for the jitter stream; draws are keyed on
                (seed, step) so re-running a step reproduces its noise.
    """

    speeds: Tuple[float, ...]
    comm_scale: Tuple[float, ...] = ()
    jitter: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if not self.speeds:
            raise ValueError("DeviceProfile needs at least one device")
        if any(s <= 0 for s in self.speeds):
            raise ValueError(f"speeds must be positive: {self.speeds}")
        if self.comm_scale and len(self.comm_scale) != len(self.speeds):
            raise ValueError("comm_scale length must match speeds")
        if self.jitter < 0:
            raise ValueError("jitter must be >= 0")

    @property
    def world_size(self) -> int:
        return len(self.speeds)

    @property
    def comm_scales(self) -> Tuple[float, ...]:
        return self.comm_scale or (1.0,) * len(self.speeds)

    def is_uniform_speed(self) -> bool:
        """True when every device computes at the same rate — balancing
        on normalized costs then degenerates to balancing on raw costs."""
        return len(set(self.speeds)) == 1

    def is_homogeneous(self) -> bool:
        """True when the profile is a no-op for the *simulator* too:
        nominal speed everywhere, nominal wire, no jitter."""
        return (all(s == 1.0 for s in self.speeds)
                and all(c == 1.0 for c in self.comm_scales)
                and self.jitter == 0.0)

    def normalized(self, cost: float, device: int) -> float:
        """Time units for `cost` on `device` (work ÷ device speed)."""
        return cost / self.speeds[device]

    def step_multipliers(self, step: int):
        """(compute_mult, comm_mult) arrays for one training step —
        multiplicative lognormal slowdowns, deterministic in (seed, step).
        With jitter == 0 returns exact ones (a bit-exact no-op)."""
        n = self.world_size
        if self.jitter == 0.0:
            ones = np.ones(n)
            return ones, ones.copy()
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + 7919 * step) % (2 ** 32))
        comp = np.exp(self.jitter * rng.standard_normal(n))
        comm = np.exp(self.jitter * rng.standard_normal(n))
        return comp, comm

    def ring_order(self) -> List[int]:
        """Device order for the ODC p2p ring: slowest devices adjacent
        (descending speed, stable), so a straggler's slow hops share one
        ring segment instead of interleaving with fast devices."""
        return sorted(range(self.world_size),
                      key=lambda d: (-self.speeds[d], d))

    def node_collapse(self, group_size: int) -> "DeviceProfile":
        """Collapse a device-granular profile to node granularity for the
        hierarchical (node × device) comm backend: devices are grouped in
        mesh order into contiguous nodes of ``group_size``; a node computes
        at its slowest member's speed (the intra-node collective barriers
        on it) and pays its most congested member's wire multiplier.
        Jitter/seed carry over so node-level draws stay reproducible."""
        if group_size <= 0 or self.world_size % group_size:
            raise ValueError(
                f"cannot collapse {self.world_size} devices into nodes of "
                f"{group_size}")
        n = self.world_size // group_size
        cs = self.comm_scales
        return dataclasses.replace(
            self,
            speeds=tuple(min(self.speeds[i * group_size:(i + 1) * group_size])
                         for i in range(n)),
            comm_scale=tuple(max(cs[i * group_size:(i + 1) * group_size])
                             for i in range(n)),
        )

    # -- canonical constructors (the fault-injection vocabulary shared by
    # tests/conftest.py and benchmarks/straggler_sweep.py) ------------------
    @classmethod
    def homogeneous(cls, world_size: int) -> "DeviceProfile":
        return cls(speeds=(1.0,) * world_size)

    @classmethod
    def one_slow(cls, world_size: int, slow_factor: float,
                 slow_rank: int = 0, **kw) -> "DeviceProfile":
        speeds = [1.0] * world_size
        speeds[slow_rank] = 1.0 / slow_factor
        return cls(speeds=tuple(speeds), **kw)

    @classmethod
    def bimodal(cls, world_size: int, slow_factor: float,
                slow_frac: float = 0.5, seed: int = 0, **kw) -> "DeviceProfile":
        """A seeded subset of devices at 1/slow_factor speed (mixed
        accelerator generations)."""
        n_slow = max(1, int(round(world_size * slow_frac)))
        rng = np.random.RandomState(seed)
        slow = set(rng.permutation(world_size)[:n_slow].tolist())
        speeds = tuple(1.0 / slow_factor if d in slow else 1.0
                       for d in range(world_size))
        return cls(speeds=speeds, seed=seed, **kw)

    @classmethod
    def uniform(cls, world_size: int, slow_factor: float,
                seed: int = 0, **kw) -> "DeviceProfile":
        """Speeds drawn U[1/slow_factor, 1] — broad thermal spread."""
        rng = np.random.RandomState(seed)
        lo = 1.0 / slow_factor
        speeds = tuple(float(s) for s in rng.uniform(lo, 1.0, world_size))
        return cls(speeds=speeds, seed=seed, **kw)


def make_straggler_profile(kind: str, world_size: int, *,
                           slow_factor: float = 2.0, seed: int = 0,
                           jitter: float = 0.0) -> DeviceProfile:
    """Seeded fault-injection profiles: 'uniform' | 'one_slow' | 'bimodal'
    (+ 'homogeneous' as the control).  slow_factor f means the affected
    devices run at 1/f nominal speed."""
    if kind not in ("homogeneous", "one_slow", "bimodal", "uniform"):
        raise ValueError(f"unknown straggler profile kind {kind!r}")
    if kind == "homogeneous" or slow_factor == 1.0:
        p = DeviceProfile.homogeneous(world_size)
        return dataclasses.replace(p, jitter=jitter, seed=seed)
    if kind == "one_slow":
        return DeviceProfile.one_slow(world_size, slow_factor,
                                      jitter=jitter, seed=seed)
    if kind == "bimodal":
        return DeviceProfile.bimodal(world_size, slow_factor,
                                     seed=seed, jitter=jitter)
    return DeviceProfile.uniform(world_size, slow_factor,
                                 seed=seed, jitter=jitter)


def get_compute_costs(seqlen_lst: Sequence[int],
                      model: CostModel = DEFAULT_COST_MODEL,
                      *, profile: Optional[DeviceProfile] = None,
                      device: Optional[int] = None) -> List[float]:
    """Paper Listing 1: compute costs given the sequence lengths.

    With a ``profile`` and a ``device``, returns *normalized* costs — the
    time the samples take on that device (work ÷ device speed) — the
    quantity LB-Mini-Het balances."""
    costs = model.costs(seqlen_lst)
    if profile is not None and device is not None:
        s = profile.speeds[device]
        return [c / s for c in costs]
    return costs


def check_oom(micro_seqlen_lst: Sequence[int], max_tokens_per_microbatch: int) -> bool:
    """Paper Listing 1: True if this microbatch violates the memory budget.

    Activation memory is linear in tokens, so the budget is a token budget.
    """
    return sum(int(s) for s in micro_seqlen_lst) > max_tokens_per_microbatch


def microbatch_tokens(seqlens: Sequence[int]) -> int:
    return sum(int(s) for s in seqlens)
