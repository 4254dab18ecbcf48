"""Task adapters: how a workload produces rollout waves and train batches
(a copy of ``repro.posttrain.tasks`` over the port's copies of
``balance``, ``data.lengths``, ``data.loader`` and ``data.packing``, and
its generation engines).

A task plugs two things into ``PostTrainPipeline``:

  * ``generate_wave(it, params, version) -> [Rollout]`` -- produce wave
    ``it``'s rollouts (GRPO: grouped rollouts with Dr.GRPO advantages,
    from either the synthetic sampler or a real ``GenerationEngine``
    decode; SFT: the next loader step's samples with unit weight);
  * ``build_batch(rollouts) -> (plan, batch)`` — balance the dispatched
    rollouts (LB-Mini / LB-Mini-Het via ``balance.make_plan``) and pack
    them into the (M, W, S) stack (``data.packing.build_minibatch``).

The split matters for the staleness semantics: generation consumes
*versions* (whatever the last weight push materialized), batch building
consumes only the FIFO rollout stream — so a staleness-0 pipeline
replays the synchronous loop sample for sample, bit for bit.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np

from repro_torch.balance.cost import (CostModel, DEFAULT_COST_MODEL,
                                      DeviceProfile)
from repro_torch.balance.strategies import make_plan
from repro_torch.data.lengths import sample_lengths, scale_spread
from repro_torch.data.loader import SyntheticSFTLoader, grpo_batch
from repro_torch.data.packing import build_minibatch
from repro_torch.posttrain.buffer import Rollout


@dataclasses.dataclass
class GRPOTask:
    """GRPO on AIME-like prompts (paper §5.1 RL).

    rollout_source='synthetic'  the paper's measurement convention: the
        rollout content comes from the seeded synthetic sampler
        (``data.loader.grpo_batch``) — generation cost is excluded, wave
        ``it`` is a pure function of ``seed + it`` (this is what the
        staleness-0 golden test pins).
    rollout_source='engine'     real prefill/decode through a
        ``GenerationEngine``: prompts are sampled, the engine greedy-
        decodes a group of rollouts per prompt under the CURRENT pushed
        weights, and per-rollout stop lengths carve the variable-length
        wave.  Rewards stay synthetic (seeded) — the paper has no reward
        model either.
    rollout_source='continuous'  the same wave through a
        ``ContinuousGenerationEngine``: requests stream through decode
        slots instead of padding to the wave's longest rollout, so short
        rollouts retire early and free their KV blocks for queued ones.
        Greedy decode is bit-identical to 'engine' per request (the
        continuous engine's core invariant), so the sample stream — and
        therefore training — is unchanged; only the schedule differs.
    """

    vocab_size: int
    prompts: int = 8
    group: int = 4
    max_len: int = 192
    max_tokens: int = 256          # token budget per microbatch buffer
    strategy: str = "lb_mini"
    seed: int = 0
    length_variance: float = 1.0
    rollout_source: str = "synthetic"
    engine: Optional[object] = None      # GenerationEngine for 'engine'
    prompt_len: int = 16
    cost_model: CostModel = DEFAULT_COST_MODEL
    profile: Optional[DeviceProfile] = None

    def __post_init__(self):
        if self.rollout_source not in ("synthetic", "engine", "continuous"):
            raise ValueError(f"unknown rollout_source "
                             f"{self.rollout_source!r}")
        if self.rollout_source == "engine" and self.engine is None:
            raise ValueError("rollout_source='engine' needs a "
                             "GenerationEngine")
        if self.rollout_source == "continuous" and self.engine is None:
            raise ValueError("rollout_source='continuous' needs a "
                             "ContinuousGenerationEngine")
        if self.max_len > self.max_tokens:
            raise ValueError(
                f"rollout max_len ({self.max_len}) exceeds the microbatch "
                f"token budget ({self.max_tokens}): rollouts would be "
                "silently truncated — raise max_tokens or cap max_len")

    @property
    def wave_size(self) -> int:
        return self.prompts * self.group

    def generate_wave(self, it: int, params, version: int) -> List[Rollout]:
        if self.rollout_source == "synthetic":
            toks, adv, _ = grpo_batch(
                self.prompts, self.group, self.vocab_size,
                max_len=self.max_len, seed=self.seed + it,
                length_variance=self.length_variance)
            return [Rollout(tokens=t, advantage=float(a), version=version)
                    for t, a in zip(toks, adv)]
        return self._engine_wave(it, params, version)

    def _wave_inputs(self, it: int):
        """The seeded (prompts, stop lengths, advantages) of wave ``it`` —
        shared by both engine paths so their sample streams coincide."""
        rng = np.random.RandomState(self.seed + it)
        B = self.wave_size
        # one prompt per group, repeated group-wise (grouped rollouts)
        prompts = rng.randint(1, self.vocab_size,
                              size=(self.prompts, self.prompt_len))
        prompts = np.repeat(prompts, self.group, axis=0).astype(np.int32)
        stops = sample_lengths("aime", B, seed=self.seed + it,
                               max_len=self.max_len)
        stops = np.minimum(scale_spread(stops, self.length_variance),
                           self.max_len)
        stops = np.maximum(stops, self.prompt_len + 1)
        rewards = rng.rand(self.prompts, self.group)
        adv = (rewards - rewards.mean(axis=1, keepdims=True)).reshape(-1)
        return prompts, stops, adv

    def _engine_wave(self, it: int, params, version: int) -> List[Rollout]:
        prompts, stops, adv = self._wave_inputs(it)
        if self.rollout_source == "continuous":
            # the live-pushed engine holds its own versioned params; when
            # driven without a pusher, install the handed-down ones
            if self.engine.version < version:
                self.engine.publish(params, version)
            start = len(self.engine.completed)
            for b in range(self.wave_size):
                self.engine.submit(prompts[b],
                                   self.max_len - self.prompt_len,
                                   stop_length=int(stops[b]))
            self.engine.run()
            done = sorted(self.engine.completed[start:],
                          key=lambda c: c.rid)
            return [Rollout(tokens=c.sequence, advantage=float(a),
                            version=c.weight_version)
                    for c, a in zip(done, adv)]
        # greedy decode: a group's rollouts differ only by their stop
        # lengths (no temperature sampling in the synthetic zoo) — rewards
        # are seeded draws either way, so advantages stay well-defined
        res = self.engine.generate(
            params, prompts, self.max_len - self.prompt_len,
            stop_lengths=stops)
        return [Rollout(tokens=t, advantage=float(a), version=version)
                for t, a in zip(res.sequences, adv)]

    def build_batch(self, rollouts: List[Rollout], world: int):
        lens = [r.length for r in rollouts]  # <= max_len <= max_tokens
        toks = [r.tokens for r in rollouts]
        adv = [r.advantage for r in rollouts]
        plan = make_plan(lens, world, self.max_tokens,
                         strategy=self.strategy,
                         cost_model=self.cost_model, profile=self.profile)
        batch = build_minibatch(plan, toks, self.max_tokens,
                                advantages=adv)
        return plan, batch


@dataclasses.dataclass
class SFTTask:
    """SFT through the same dispatch path: every sample is a unit-weight
    'rollout' produced by the deterministic loader — generation is free
    and version-independent, so the pipeline degenerates to the
    synchronous ``launch.train`` loop (same plans, same batches)."""

    vocab_size: int
    world: int
    dataset: str = "longalign"
    minibatch_per_device: int = 4
    max_tokens: int = 512
    max_len: int = 384
    strategy: str = "lb_mini"
    seed: int = 0
    cost_model: CostModel = DEFAULT_COST_MODEL
    profile: Optional[DeviceProfile] = None
    extras: Optional[dict] = None

    def __post_init__(self):
        self._loader = SyntheticSFTLoader(
            self.dataset, vocab_size=self.vocab_size, world_size=self.world,
            minibatch_per_device=self.minibatch_per_device,
            max_tokens=self.max_tokens, strategy=self.strategy,
            max_len=self.max_len, cost_model=self.cost_model,
            seed=self.seed, device_profile=self.profile)
        self._steps = None
        self._plans = deque()  # loader plans, FIFO alongside the rollouts

    @property
    def wave_size(self) -> int:
        return self.world * self.minibatch_per_device

    def generate_wave(self, it: int, params, version: int) -> List[Rollout]:
        if self._steps is None:
            # the loader's zipf token stream is sequential: waves must be
            # pulled in order (the pipeline always does)
            self._steps = self._loader.steps(2 ** 31 - 1)
        data = next(self._steps)
        self._plans.append(data["plan"])
        return [Rollout(tokens=t, advantage=None, version=version)
                for t in data["sample_tokens"]]

    def build_batch(self, rollouts: List[Rollout], world: int):
        toks = [r.tokens for r in rollouts]
        # the loader already balanced this wave; waves dispatch FIFO, so
        # the plan queue stays aligned with the rollout stream (guarded)
        plan = self._plans.popleft()
        assert sum(len(mb) for dev in plan.assignments
                   for mb in dev) == len(rollouts)
        batch = build_minibatch(plan, toks, self.max_tokens,
                                extras=self.extras)
        return plan, batch
