"""Carry trees of arrays between the JAX package and the port.

The JAX side hands over its parameters or caches as numpy arrays
(``jax.tree.map(np.asarray, params)``); ``params_from_numpy`` turns such a
nested dict into the port's dict of tensors, same keys, same stacked
``(L, ...)`` leaves, so both packages compute with the same weights.
``train_state_from_numpy`` does the same for a train state, parameters and
AdamW state, and shards it over a trainer's ranks.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device, dtype=None):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``.
    Floating leaves are cast to ``dtype`` when it is given; integer leaves
    keep their type.  Works for parameter trees and for caches."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    if tree is None:
        return None
    t = torch.from_numpy(np.array(tree, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)



def train_state_from_numpy(params, opt_state, trainer, dtype=None):
    """JAX parameters and AdamW state (numpy trees, ``{"m", "v", "step"}``)
    -> the port's per-rank shards and per-rank optimizer states for
    ``trainer`` (a ``core.train_step.Trainer``): every rank's shard of
    m and v is the shard of the parameter it belongs to."""
    from repro_torch.core import fsdp

    cpu = params_from_numpy(params, "cpu", dtype)
    shards = fsdp.shard_params(cpu, trainer.ranks)
    m = fsdp.shard_params(params_from_numpy(opt_state["m"], "cpu"),
                          trainer.ranks)
    v = fsdp.shard_params(params_from_numpy(opt_state["v"], "cpu"),
                          trainer.ranks)
    step = torch.tensor(int(np.asarray(opt_state["step"])), dtype=torch.int32)
    opts = [{"m": m[r], "v": v[r], "step": step.clone()}
            for r in range(len(shards))]
    return shards, opts
