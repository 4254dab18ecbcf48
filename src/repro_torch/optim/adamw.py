"""Sharded AdamW, the PyTorch counterpart of ``repro.optim.adamw``.

Operates leaf-wise on nested dicts of tensors, in particular on one rank's
shard storage: the optimizer state never moves (the "server" role of the
decentralized parameter server).  The update is elementwise f32 with the
global-norm clip, in the reference's order of operations; it returns new
dicts and leaves its inputs as they were.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0  # global-norm clip; 0 disables


def tree_leaves(tree):
    """Leaves of a nested dict in the order ``jax.tree.leaves`` gives
    (keys sorted at every level)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def adamw_init(params):
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 on the first
    leaf's device."""
    dev = leaves[0].device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for x in leaves:
        total = total + x.float().square().sum().to(dev)
    return torch.sqrt(total)


def adamw_update(cfg: AdamWConfig, params, grads, state, lr_scale=1.0,
                 grad_norm: Optional[torch.Tensor] = None):
    """One AdamW step.  ``grad_norm`` may be supplied when the leaves are
    shards of a larger tree (pass the true global norm)."""
    step = state["step"] + 1
    scale = None
    if cfg.grad_clip > 0:
        gn = global_norm(tree_leaves(grads)) if grad_norm is None \
            else grad_norm
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12),
                            max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** stepf
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** stepf
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        dev = p.device
        if scale is not None:
            g = g * scale.to(dev)
        g32 = g.float()
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * g32.square()
        mhat = m / c1.to(dev)
        vhat = v / c2.to(dev)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        lr_d = lr.to(dev) if isinstance(lr, torch.Tensor) else lr
        return (p.float() - lr_d * delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state["m"], state["v"])
    return _unzip(out, 0), {"m": _unzip(out, 1), "v": _unzip(out, 2),
                            "step": step}


def _unzip(tree, i):
    if isinstance(tree, dict):
        return {k: _unzip(v, i) for k, v in tree.items()}
    return tree[i]
