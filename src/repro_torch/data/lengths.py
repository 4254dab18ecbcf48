"""Synthetic sequence-length distributions matching the paper's datasets.

The paper's claims are pure throughput/utilization; what matters for
reproduction is the *length distribution* (Fig. 7), not token content:

  longalign  — long-context alignment corpus: heavy long tail up to 64k
               (log-normal body + uniform long tail)
  swesmith   — SWE-agent trajectories: long, moderately dispersed (tens of
               k tokens), capped at 32k
  aime       — RL rollouts on math problems: reasoning traces, less
               long-tailed than SFT corpora (the paper's §5.2 observation),
               capped at 16k

``sample_lengths(name, n, seed)`` is deterministic per seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class LengthSpec:
    mu: float          # log-normal location
    sigma: float       # log-normal scale
    max_len: int
    min_len: int = 32
    tail_frac: float = 0.0   # extra uniform mass on [tail_lo, max_len]
    tail_lo: int = 0


DATASETS: Dict[str, LengthSpec] = {
    # long-context alignment: median ~9k, mean ~14k, p99 ~60k (max 64k)
    "longalign": LengthSpec(mu=9.1, sigma=0.95, max_len=65_536,
                            tail_frac=0.03, tail_lo=24_576),
    # median ~8k, bulk 2k-30k — SWE-Smith-like (max 32k)
    "swesmith": LengthSpec(mu=8.9, sigma=0.85, max_len=32_768),
    # median ~3k, lighter tail — AIME rollouts (max 16k)
    "aime": LengthSpec(mu=8.0, sigma=0.75, max_len=16_384),
}


def sample_lengths(dataset: str, n: int, seed: int = 0,
                   max_len: int = 0) -> np.ndarray:
    """n int lengths; max_len overrides the dataset cap (parametric study
    §5.3 rescales by truncating/repeating at a fixed ratio — here we rescale
    the distribution so its *shape* is preserved, as the paper does)."""
    spec = DATASETS[dataset]
    rng = np.random.RandomState(seed)
    lens = rng.lognormal(spec.mu, spec.sigma, size=n)
    if spec.tail_frac > 0:
        t = rng.rand(n) < spec.tail_frac
        lens[t] = rng.uniform(spec.tail_lo, spec.max_len, size=t.sum())
    lens = np.clip(lens, spec.min_len, spec.max_len)
    if max_len and max_len != spec.max_len:
        lens = lens * (max_len / spec.max_len)
        lens = np.clip(lens, spec.min_len, max_len)
    return lens.astype(np.int64)


def scale_spread(lens: np.ndarray, factor: float,
                 min_len: int = 1) -> np.ndarray:
    """Stretch (factor > 1) or shrink a length sample's spread around its
    mean without moving the mean: ``l' = mean + (l - mean) * factor``,
    floored at ``min_len``.  ``factor=1`` returns the input bit-identically.
    Used by the posttrain sweeps to dial rollout-length variance while
    holding total work roughly constant."""
    if factor == 1.0:
        return lens
    lens = np.asarray(lens, np.float64)
    out = lens.mean() + (lens - lens.mean()) * factor
    return np.maximum(out, min_len).astype(np.int64)
