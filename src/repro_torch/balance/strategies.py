"""Load-balancing strategies from the paper (§4, §5.1, Appendix C).

Every strategy maps (seqlens of one minibatch's global samples, world_size,
memory budget) to a ``Plan``: per-device lists of microbatches, each
microbatch a list of sample indices.

  LocalSort      — samples round-robin'd to devices, sorted by length within
                   each device, one sample per microbatch (no packing)
                   [adapted from LongAlign].
  LB-Micro       — heuristic packing that balances devices *within each
                   microbatch* (same microbatch count everywhere) — the
                   strong collective-compatible baseline.
  LB-Mini        — the paper's §4 algorithm: Karmarkar–Karp balances total
                   compute across devices at the *minibatch* level, then
                   each device independently packs its local samples under
                   its own memory budget.  Devices may end up with different
                   microbatch counts — only valid with ODC.
  LB-Mini-Het    — LB-Mini extended with a per-device speed model
                   (``DeviceProfile``): the KK partition is matched to
                   devices so that *normalized* load (work ÷ device speed)
                   is minimized, then a greedy rebalance pass migrates
                   whole microbatches off stragglers while it lowers the
                   peak normalized load.  Degenerates to LB-Mini (identical
                   assignments) when every device has the same speed.
  verl_native    — verl's two-level scheme (global balance first, then
                   minibatch split): the weak RL baseline (Listing 2).
  verl_optimized — the paper's fixed ordering (split minibatches first,
                   then balance each across devices): Listing 3.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.balance.cost import (
    CostModel,
    DEFAULT_COST_MODEL,
    DeviceProfile,
    get_compute_costs,
)
from repro_torch.balance.kk import karmarkar_karp


@dataclasses.dataclass
class Plan:
    """device -> list of microbatches -> list of global sample indices.

    ``profile`` records the device model the plan was balanced for (None =
    homogeneous assumption); the simulator picks it up so a plan
    round-trips with the heterogeneity it was built against.

    Context parallelism (``lb_token``): with ``cp > 1`` each "device" row
    of ``assignments`` is one cp ring *group* of ``cp`` adjacent devices;
    ``cp_cells[g][m]`` lists the ``cp`` per-rank cells of group g's m-th
    microbatch (a sample in ``cp_split`` appears in every cell — its
    tokens are sequence-sharded over the whole ring; other samples sit
    whole in exactly one cell).  ``assignments[g][m]`` stays the union, so
    ``validate`` and sample accounting are cp-agnostic."""

    assignments: List[List[List[int]]]
    strategy: str = ""
    profile: Optional[DeviceProfile] = None
    cp: int = 1
    cp_cells: Optional[List[List[List[List[int]]]]] = None
    cp_split: frozenset = frozenset()

    @property
    def world_size(self) -> int:
        return len(self.assignments)

    @property
    def max_microbatches(self) -> int:
        return max((len(d) for d in self.assignments), default=0)

    def uniform_microbatches(self) -> bool:
        counts = {len(d) for d in self.assignments}
        return len(counts) <= 1

    def device_costs(self, costs: Sequence[float]) -> List[float]:
        return [sum(costs[i] for mb in dev for i in mb)
                for dev in self.assignments]

    def normalized_loads(self, costs: Sequence[float],
                         profile: Optional[DeviceProfile] = None
                         ) -> List[float]:
        """Per-device time (work ÷ device speed) under ``profile`` (falls
        back to the plan's own profile, then to homogeneous speeds)."""
        profile = profile or self.profile
        raw = self.device_costs(costs)
        if profile is None:
            return raw
        return [profile.normalized(c, d) for d, c in enumerate(raw)]

    def validate(self, num_samples: int):
        seen = sorted(i for dev in self.assignments for mb in dev for i in mb)
        assert seen == list(range(num_samples)), "plan must cover every sample exactly once"


# ---------------------------------------------------------------------------
# microbatch packing under a token budget
# ---------------------------------------------------------------------------
def microbatch_partition(minibatch_costs: Sequence[float],
                         minibatch_seqlens: Sequence[int],
                         max_tokens: int,
                         *, equal_size: bool = False) -> List[List[int]]:
    """Paper Listing 1: iteratively increase the microbatch count until no
    microbatch violates the (token) memory budget."""
    n = len(minibatch_seqlens)
    if n == 0:
        return [[]]
    k = max(1, int(np.ceil(sum(minibatch_seqlens) / max(max_tokens, 1))))
    while True:
        parts = karmarkar_karp(list(minibatch_costs), k, equal_size=equal_size)
        ok = all(sum(minibatch_seqlens[i] for i in p) <= max_tokens
                 for p in parts if p)
        if ok or k >= n:
            return [p for p in parts if p] or [[]]
        k += 1


def minibatch_partition(global_costs: Sequence[float], world_size: int,
                        *, equal_size: bool) -> List[List[int]]:
    """Paper Listing 1: balance the global minibatch across devices."""
    return karmarkar_karp(list(global_costs), world_size,
                          equal_size=equal_size)


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------
def local_sort(seqlens: Sequence[int], world_size: int, max_tokens: int,
               cost_model: CostModel = DEFAULT_COST_MODEL) -> Plan:
    """Dataloader-natural (hash-shuffled) distribution, sort by length
    locally, no packing — the LongAlign baseline."""
    order = list(np.random.RandomState(len(seqlens)).permutation(len(seqlens)))
    devices: List[List[int]] = [[] for _ in range(world_size)]
    for j, idx in enumerate(order):
        devices[j % world_size].append(int(idx))
    assignments = []
    for dev in devices:
        dev_sorted = sorted(dev, key=lambda i: seqlens[i])
        assignments.append([[i] for i in dev_sorted])
    # pad so every device has the same number of microbatches (collective
    # compatibility: empty microbatches are no-ops but keep devices in step)
    m = max(len(d) for d in assignments)
    for d in assignments:
        d.extend([[] for _ in range(m - len(d))])
    return Plan(assignments, "LocalSort")


def lb_micro(seqlens: Sequence[int], world_size: int, max_tokens: int,
             cost_model: CostModel = DEFAULT_COST_MODEL) -> Plan:
    """Balance across devices *within each microbatch wave* (uniform
    microbatch count — collective-compatible).

    1. choose the common per-device microbatch count k (memory-driven);
    2. Karmarkar–Karp the whole minibatch into k·W cost-balanced
       microbatches under the token budget;
    3. sort microbatches by cost and give each *wave* W of adjacent cost,
       so the per-layer barrier (max over devices) wastes as little as
       possible in every wave.
    """
    costs = get_compute_costs(seqlens, cost_model)
    n = len(seqlens)
    W = world_size
    total_tokens = sum(seqlens)
    k = max(1, int(np.ceil(total_tokens / max(max_tokens * W, 1))))
    while True:
        parts = karmarkar_karp(costs, k * W, equal_size=False)
        ok = all(sum(seqlens[i] for i in p) <= max_tokens for p in parts)
        if ok or k * W >= n:
            break
        k += 1
    part_costs = [sum(costs[i] for i in p) for p in parts]
    order = sorted(range(len(parts)), key=lambda j: -part_costs[j])
    assignments: List[List[List[int]]] = [[] for _ in range(W)]
    load = [0.0] * W
    for w in range(k):
        wave = order[w * W: (w + 1) * W]
        # LPT across waves: biggest microbatch of the wave goes to the
        # least-loaded device, equalizing *total* device time as well
        # (irrelevant under per-layer barriers, decisive under ODC).
        by_load = sorted(range(W), key=lambda d: load[d])
        for slot, j in enumerate(wave):
            d = by_load[slot]
            assignments[d].append(parts[j])
            load[d] += part_costs[j]
        for slot in range(len(wave), W):
            assignments[by_load[slot]].append([])
    return Plan(assignments, "LB-Micro")


def _pack_device_parts(device_parts, costs, seqlens, max_tokens
                       ) -> List[List[List[int]]]:
    """Per-device local packing under the token budget (paper Listing 1)
    — shared by LB-Mini and LB-Mini-Het so the uniform-speed case stays
    byte-identical by construction."""
    assignments = []
    for part in device_parts:
        local_costs = [costs[i] for i in part]
        local_lens = [seqlens[i] for i in part]
        local_mbs = microbatch_partition(local_costs, local_lens, max_tokens)
        assignments.append([[part[i] for i in mb] for mb in local_mbs])
    return assignments


def lb_mini(seqlens: Sequence[int], world_size: int, max_tokens: int,
            cost_model: CostModel = DEFAULT_COST_MODEL) -> Plan:
    """Paper §4: balance total compute across devices at the minibatch
    level (unequal sample counts allowed), then pack locally under the
    memory budget.  Microbatch counts may differ per device → ODC only."""
    costs = get_compute_costs(seqlens, cost_model)
    device_parts = minibatch_partition(costs, world_size, equal_size=False)
    return Plan(_pack_device_parts(device_parts, costs, seqlens, max_tokens),
                "LB-Mini")


def lb_mini_het(seqlens: Sequence[int], world_size: int, max_tokens: int,
                cost_model: CostModel = DEFAULT_COST_MODEL,
                profile: Optional[DeviceProfile] = None,
                max_migrations: Optional[int] = None) -> Plan:
    """Heterogeneity-aware LB-Mini: balance *normalized* load (work ÷
    device speed) instead of raw compute.

    1. Karmarkar–Karp the minibatch into W parts on raw costs (same call
       as LB-Mini, so the uniform-speed case is assignment-identical);
    2. match parts to devices largest-sum → fastest-device, which
       minimizes the peak *normalized* load over all part→device
       matchings (pairing sorted sums with sorted speeds: any inversion
       can only raise the max ratio);
    3. pack each device's samples locally under its token budget (paper
       Listing 1, unchanged);
    4. greedy rebalance: while it strictly lowers the peak normalized
       load, migrate one whole microbatch off the most-loaded device onto
       the least-loaded one (whole microbatches already satisfy the token
       budget, so a migrated one rides along as an extra microbatch on
       the receiver — legal under ODC, where microbatch counts may
       differ per device).

    With a uniform-speed (or absent) profile every step degenerates to
    LB-Mini and the assignments are byte-identical to ``lb_mini``'s.
    """
    if profile is not None and profile.world_size != world_size:
        raise ValueError(
            f"profile has {profile.world_size} devices, world={world_size}")
    if profile is None or profile.is_uniform_speed():
        base = lb_mini(seqlens, world_size, max_tokens, cost_model)
        return Plan(base.assignments, "LB-Mini-Het", profile=profile)

    costs = get_compute_costs(seqlens, cost_model)
    device_parts = minibatch_partition(costs, world_size, equal_size=False)

    # largest-sum part → fastest device (minimizes max over d of
    # part_sum / speed_d among all matchings)
    part_sums = [sum(costs[i] for i in p) for p in device_parts]
    by_sum = sorted(range(world_size), key=lambda j: (-part_sums[j], j))
    by_speed = sorted(range(world_size),
                      key=lambda d: (-profile.speeds[d], d))
    matched: List[List[int]] = [[] for _ in range(world_size)]
    for j, d in zip(by_sum, by_speed):
        matched[d] = device_parts[j]

    assignments = _pack_device_parts(matched, costs, seqlens, max_tokens)

    # greedy straggler-relief pass: move whole microbatches downhill
    def mb_cost(mb):
        return sum(costs[i] for i in mb)

    loads = Plan(assignments).normalized_loads(costs, profile)
    # None = auto budget; 0 is honored (matching-only, no migration pass)
    budget = (max_migrations if max_migrations is not None
              else 4 * world_size * max(
                  (len(d) for d in assignments), default=1))
    for _ in range(budget):
        src = max(range(world_size), key=lambda d: loads[d])
        peak = loads[src]
        best = None  # (new_peak, dst, mb_index)
        for dst in range(world_size):
            if dst == src:
                continue
            for m, mb in enumerate(assignments[src]):
                c = mb_cost(mb)
                new_src = loads[src] - c / profile.speeds[src]
                new_dst = loads[dst] + c / profile.speeds[dst]
                new_peak = max(new_src, new_dst)
                if best is None or new_peak < best[0]:
                    best = (new_peak, dst, m)
        if best is None or best[0] >= peak - 1e-12:
            break
        _, dst, m = best
        mb = assignments[src].pop(m)
        assignments[dst].append(mb)
        c = mb_cost(mb)
        loads[src] -= c / profile.speeds[src]
        loads[dst] += c / profile.speeds[dst]

    # a fully-drained device keeps an empty microbatch *list* (no phantom
    # empty microbatch — the simulator charges per-microbatch comm, and a
    # drained straggler genuinely does nothing until the minibatch barrier)
    return Plan(assignments, "LB-Mini-Het", profile=profile)


def lb_token(seqlens: Sequence[int], world_size: int, max_tokens: int,
             cost_model: CostModel = DEFAULT_COST_MODEL, *,
             cp: int = 1, split_threshold: Optional[int] = None) -> Plan:
    """Token-level chunk balancing for context parallelism (§cp backend).

    The world is viewed as ``G = world_size // cp`` ring groups × ``cp``
    ranks.  Sequences at least ``split_threshold`` long (default 4× the
    minibatch median — inclusive, so an exactly-4×-median dominant
    splits; anything over the per-rank token budget is always split)
    are cp-split: their tokens are sequence-sharded over all cp
    ranks of one group (head+tail interleaved chunks), landing as
    cost/cp and tokens/cp per rank — the single-long-sequence straggler
    becomes a group-wide wave instead of one device's tail.  Short
    sequences stay whole in one (group, rank) cell.

    1. Karmarkar–Karp the minibatch into G groups on *effective* costs
       (cost/cp for split samples) — balances total group load;
    2. per group, split samples pack into group-wide waves under the
       per-rank token budget (paper Listing 1 on the /cp footprints);
    3. per group, whole samples pack into per-rank cells (Listing 1),
       then cp adjacent-cost cells form one wave (LB-Micro's trick at
       cell granularity) — the wave's time is its slowest cell.

    ``cp=1`` degenerates to LB-Mini's exact assignments (same KK calls),
    so flat-ODC parity at cp=1 holds by construction.
    """
    if cp <= 1:
        base = lb_mini(seqlens, world_size, max_tokens, cost_model)
        return Plan(base.assignments, "LB-Token", cp=1)
    if world_size % cp:
        raise ValueError(
            f"world_size {world_size} not divisible by cp={cp}")
    G = world_size // cp
    costs = get_compute_costs(seqlens, cost_model)
    med = float(np.median(seqlens)) if len(seqlens) else 0.0
    thr = (int(split_threshold) if split_threshold is not None
           else max(1, int(4 * med)))
    if max_tokens:
        thr = min(thr, max_tokens)  # over-budget sequences MUST split
    split = frozenset(i for i, l in enumerate(seqlens) if l >= thr)

    eff = [costs[i] / cp if i in split else costs[i]
           for i in range(len(seqlens))]
    groups = karmarkar_karp(eff, G, equal_size=False)

    assignments: List[List[List[int]]] = []
    cp_cells: List[List[List[List[int]]]] = []
    for part in groups:
        longs = [i for i in part if i in split]
        shorts = [i for i in part if i not in split]
        mbs: List[List[int]] = []
        cells: List[List[List[int]]] = []
        if longs:
            lc = [costs[i] / cp for i in longs]
            ll = [max(1, seqlens[i] // cp) for i in longs]
            for mb in microbatch_partition(lc, ll, max_tokens):
                idx = [longs[i] for i in mb]
                if idx:
                    mbs.append(idx)
                    cells.append([list(idx) for _ in range(cp)])
        if shorts:
            sc = [costs[i] for i in shorts]
            sl = [seqlens[i] for i in shorts]
            # cell count rounded UP to a multiple of cp: a wave's time is
            # its slowest cell, so leaving ranks empty buys nothing —
            # spread the whole-sample load over every rank of each wave
            k = max(1, int(np.ceil(sum(sl) / max(max_tokens, 1))))
            k = min(len(shorts), cp * int(np.ceil(k / cp)))
            while True:
                parts = karmarkar_karp(sc, k, equal_size=False)
                if all(sum(sl[i] for i in p) <= max_tokens
                       for p in parts if p) or k >= len(shorts):
                    break
                k += cp
            cell_idx = [[shorts[i] for i in mb] for mb in parts if mb]
            cell_cost = [sum(costs[i] for i in c) for c in cell_idx]
            order = sorted(range(len(cell_idx)),
                           key=lambda j: (-cell_cost[j], j))
            for w in range(0, len(order), cp):
                wave = [cell_idx[j] for j in order[w: w + cp]]
                wave += [[] for _ in range(cp - len(wave))]
                mbs.append([i for c in wave for i in c])
                cells.append(wave)
        if not mbs:
            mbs, cells = [[]], [[[] for _ in range(cp)]]
        assignments.append(mbs)
        cp_cells.append(cells)
    return Plan(assignments, "LB-Token", cp=cp, cp_cells=cp_cells,
                cp_split=split)


def verl_native(seqlens: Sequence[int], world_size: int, max_tokens: int,
                minibatch_size: int,
                cost_model: CostModel = DEFAULT_COST_MODEL) -> List[Plan]:
    """Listing 2: balance the *global batch* across devices first, then
    split each device's share into minibatches — fails to balance within
    minibatches.  Returns one Plan per minibatch (PPO step)."""
    costs = get_compute_costs(seqlens, cost_model)
    rank_parts = karmarkar_karp(costs, world_size, equal_size=True)
    n_mini = max(1, int(np.ceil(max(len(p) for p in rank_parts)
                                / max(minibatch_size, 1))))
    plans = []
    for step in range(n_mini):
        assignments = []
        for part in rank_parts:
            part_sorted = sorted(part)
            lo = step * minibatch_size
            chunk = part_sorted[lo: lo + minibatch_size]
            local_costs = [costs[i] for i in chunk]
            local_lens = [seqlens[i] for i in chunk]
            mbs = microbatch_partition(local_costs, local_lens, max_tokens)
            assignments.append([[chunk[i] for i in mb] for mb in mbs])
        m = max(len(d) for d in assignments)
        for d in assignments:  # per-layer sync ⇒ equalized microbatch count
            d.extend([[] for _ in range(m - len(d))])
        plans.append(Plan(assignments, "verl-native"))
    return plans


def verl_optimized(seqlens: Sequence[int], world_size: int, max_tokens: int,
                   minibatch_size: int,
                   cost_model: CostModel = DEFAULT_COST_MODEL,
                   seed: int = 0) -> List[Plan]:
    """Listing 3: split minibatches first, then balance each minibatch
    across ranks (LB-Micro-quality balancing per PPO step)."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(seqlens))
    step = minibatch_size * world_size
    plans = []
    for lo in range(0, len(order), step):
        idx = [int(i) for i in order[lo: lo + step]]
        sub_lens = [seqlens[i] for i in idx]
        plan = lb_micro(sub_lens, world_size, max_tokens, cost_model)
        remapped = [[[idx[i] for i in mb] for mb in dev]
                    for dev in plan.assignments]
        plans.append(Plan(remapped, "verl-optimized"))
    return plans


STRATEGIES = {
    "local_sort": local_sort,
    "lb_micro": lb_micro,
    "lb_mini": lb_mini,
    "lb_mini_het": lb_mini_het,
    "lb_token": lb_token,
}


def make_plan(seqlens: Sequence[int], world_size: int, max_tokens: int, *,
              strategy: str = "lb_mini",
              cost_model: CostModel = DEFAULT_COST_MODEL,
              profile: Optional[DeviceProfile] = None,
              cp: int = 1) -> Plan:
    """Resolve a strategy name and balance one minibatch — the single entry
    point shared by the loaders, the posttrain dispatch queue, and the
    drivers (only ``lb_mini_het`` takes a device profile and only
    ``lb_token`` takes a cp degree, so callers no longer special-case the
    kwargs)."""
    fn = STRATEGIES[strategy]
    kw = {}
    if strategy == "lb_mini_het":
        kw["profile"] = profile
    if strategy == "lb_token":
        kw["cp"] = cp
    return fn([int(l) for l in seqlens], world_size, max_tokens, cost_model,
              **kw)
