"""FSDP storage layout: which dim of each parameter is sharded over the
ranks, and the conversions between a full parameter tree and the ranks'
shards.

The rule is ``repro.core.gspmd.leaf_pspec`` with the model axis off and
the data axis the only mesh axis: ``embed`` on dim 1; ``lm_head``,
``wq``, ``wk``, ``wv``, ``w_gate`` and ``w_up`` on dim 0; ``wo`` and
``w_down`` on dim 1; every other leaf (norms) on its last dim; stacked
``(L, ...)`` leaves under ``layers`` one dim later.  A dim that the rank
count does not divide is not sharded (``sanitize_spec``): the leaf is
replicated, every rank holds all of it, and its gradient is summed over
the ranks.

Rank r's shard of a leaf sharded on dim d is the r-th of n equal pieces
along d, as ``shard_map`` hands it out.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

STACK_KEY = "layers"
_DIM0 = ("lm_head", "wq", "wk", "wv", "w_gate", "w_up")
_DIM1 = ("embed", "wo", "w_down")


def leaf_dim(path: Sequence[str], shape, n: int) -> Optional[int]:
    """The sharded dim of the leaf at ``path`` (a key tuple) with this
    full shape, or None when the leaf is replicated over n ranks."""
    name = path[-1]
    stacked = 1 if path[0] == STACK_KEY else 0
    logical = len(shape) - stacked
    if name in _DIM0:
        d = 0
    elif name in _DIM1:
        d = 1
    else:
        d = logical - 1
    dim = stacked + d
    if shape[dim] % n or shape[dim] < n:
        return None
    return dim


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def leaf_dims(params, n: int):
    """Tree of the sharded dim of every leaf (None = replicated)."""
    return _map(lambda p, x: leaf_dim(p, tuple(x.shape), n), params)


def layer_dims(dims):
    """The dims of one layer's slice of the stacked leaves."""
    return _map(lambda p, d: None if d is None else d - 1, dims[STACK_KEY])


def shard_params(params, ranks) -> List[dict]:
    """Full tree -> one shard tree per rank, each on its rank's device."""
    n = len(ranks.devices)
    dims = leaf_dims(params, n)

    def piece(r):
        def f(path, x):
            d = get(dims, path)
            if d is None:
                return x.detach().to(ranks.devices[r], copy=True)
            return x.detach().chunk(n, dim=d)[r].to(
                ranks.devices[r], copy=True).contiguous()
        return _map(f, params)

    return [piece(r) for r in range(n)]


def unshard_params(shards: Sequence[dict], dims, device="cpu"):
    """One shard tree per rank -> the full tree on ``device``, with
    ``dims`` the tree of sharded dims (``leaf_dims`` of the full tree); a
    replicated leaf is taken from rank 0."""
    def f(path, d):
        parts = [get(s, path).to(device) for s in shards]
        return parts[0] if d is None else torch.cat(parts, dim=d)

    return _map(f, dims)


def tree_paths(tree, path=()):
    """Every leaf's key path, in sorted key order (``jax.tree.leaves``
    order)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k],
                                                            path + (k,))]
    return [path]


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value
