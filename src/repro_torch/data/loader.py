"""Deterministic synthetic data loaders for the example drivers.

``SyntheticSFTLoader`` yields per-step training batches with the chosen
dataset's length distribution, already balanced by a strategy from
``repro.balance`` and packed into fixed token buffers.

``grpo_batch`` builds an RL (GRPO-style) minibatch: groups of rollouts per
prompt with per-token advantage weights in ``loss_mask`` (signed weights —
the loss kernel treats |mask| as token weight, sign as advantage direction),
matching how the paper's RL phase trains on grouped AIME rollouts.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from repro_torch.balance.cost import CostModel, DEFAULT_COST_MODEL, DeviceProfile
from repro_torch.balance.strategies import STRATEGIES, Plan, make_plan
from repro_torch.data.lengths import sample_lengths, scale_spread


class SyntheticSFTLoader:
    def __init__(self, dataset: str, *, vocab_size: int, world_size: int,
                 minibatch_per_device: int, max_tokens: int,
                 strategy: str = "lb_mini", max_len: int = 0,
                 cost_model: CostModel = DEFAULT_COST_MODEL, seed: int = 0,
                 device_profile: Optional[DeviceProfile] = None,
                 cp: int = 1):
        self.dataset = dataset
        self.vocab = vocab_size
        self.world = world_size
        self.mb_per_dev = minibatch_per_device
        self.max_tokens = max_tokens
        self.strategy = STRATEGIES[strategy]
        self.strategy_name = strategy
        self.max_len = max_len
        self.cost_model = cost_model
        self.seed = seed
        self.device_profile = device_profile
        self.cp = cp  # context-parallel degree (used by strategy lb_token)

    def steps(self, num_steps: int, skip: int = 0) -> Iterator[dict]:
        """Yield per-step batches.  ``skip`` fast-forwards a resumed run:
        the first ``skip`` steps advance the sequential token rng (so the
        stream stays bit-identical to an uninterrupted run) but skip the
        balancer — plans are pure functions of the per-step-seeded
        lengths, so nothing else needs replaying."""
        rng = np.random.RandomState(self.seed)
        for step in range(num_steps):
            n = self.world * self.mb_per_dev
            lens = sample_lengths(self.dataset, n, seed=self.seed + step,
                                  max_len=self.max_len)
            lens = np.minimum(lens, self.max_tokens)
            # zipf-distributed tokens: a learnable unigram structure, so the
            # example drivers show real loss descent below ln(V)
            toks = [np.minimum(rng.zipf(1.3, size=int(s)),
                               self.vocab - 1).astype(np.int32)
                    for s in lens]
            if step < skip:
                continue
            plan: Plan = make_plan(
                lens, self.world, self.max_tokens,
                strategy=self.strategy_name, cost_model=self.cost_model,
                profile=self.device_profile, cp=self.cp)
            yield {"plan": plan, "lengths": lens, "sample_tokens": toks}


def grpo_batch(num_prompts: int, group_size: int, vocab_size: int,
               max_len: int = 4096, seed: int = 0,
               length_variance: float = 1.0):
    """Grouped rollouts with normalized advantages (Dr.GRPO-style: group
    mean subtracted, no std division).  Returns (sample_tokens, advantages,
    lengths).

    ``length_variance`` stretches the rollout-length spread around its mean
    (``lengths.scale_spread``) — the knob the async-dispatch sweep turns;
    1.0 leaves the AIME distribution bit-identical to before.
    """
    rng = np.random.RandomState(seed)
    lens = sample_lengths("aime", num_prompts * group_size, seed=seed,
                          max_len=max_len)
    lens = np.minimum(scale_spread(lens, length_variance), max_len)
    toks = [rng.randint(1, vocab_size, size=int(s)).astype(np.int32)
            for s in lens]
    rewards = rng.rand(num_prompts, group_size)
    adv = rewards - rewards.mean(axis=1, keepdims=True)
    return toks, adv.reshape(-1), lens
