"""FSDP storage layout: which dim of each parameter is sharded over the
ranks, and the conversions between a full parameter tree and the ranks'
shards.

The rule is ``repro.core.gspmd.leaf_pspec`` with the model axis off and
the data axis the only mesh axis: ``embed`` on dim 1; ``lm_head``,
``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up`` and mamba's ``in_proj`` on
dim 0; ``wo``, ``w_down``, ``out_proj`` and ``conv_w`` on dim 1; every
other leaf (the 1-D leaves: norms, and mamba's ``conv_b``, ``dt_bias``,
``A_log``, ``D`` and ``gate_norm``) on its last dim; a stacked leaf as many
dims later as its group's stack depth (``stack_depth``, the rule of
``repro.core.fsdp.stack_spec`` and ``gspmd._stack_rank_for_path``):
``layers`` (L, ...) of the dense and ssm families 1; the hybrid family's
``mamba`` (n_super, P, ...) 2, ``mamba_tail`` (tail, ...) 1 and
``shared_attn`` 0 (one block, not stacked); the moe family's
``layers/moe`` (n_super, ...) 1 and ``layers/dense`` (n_super, P-1, ...)
2; the audio family's ``enc_layers`` and ``dec_layers`` 1 each (the
decoder block's ``cross`` attention and ``cross_norm`` shard as any
attention and norm leaves).  The moe block's leaves: ``router`` (d, E)
on dim 0; the experts
``w_up`` and ``w_gate`` (E, d, f) on dim 1 and ``w_down`` (E, f, d) on
dim 2, told apart from a dense FFN's leaves of the same names by their
parent key ``moe`` (a stacked ``shared_mlp`` leaf has the same rank as a
sliced expert leaf, the collision ``gspmd._logical_rank`` warns of).
Under weight-stationary expert parallelism (``ep``, the reference's
``moe_ep='data'`` when the rank count divides E) the experts shard on
their E dim instead, and their dim is ``Stationary``: they are never
gathered or scattered, tokens travel to them.  A dim that the rank
count does not divide is not sharded (``sanitize_spec``): the leaf is
replicated, every rank holds all of it, and its gradient is summed over
the ranks.

Rank r's shard of a leaf sharded on dim d is the r-th of n equal pieces
along d, as ``shard_map`` hands it out.

Under a two-tier layout (``ranks.Tiers``: the ``hier`` and ``pipe``
backends' (inter, intra) data axes) every leaf above shards over both
tiers, node-major, exactly as over the flat ranks -- except the leaves
of the last rule (1-D): ``leaf_pspec`` shards those over the innermost
data axis only.  Their dim is an ``IntraDim``: rank ``t*intra + d`` holds
piece d of ``intra``, the pieces are replicated across the groups, a
gather concatenates a group's pieces, and their gradients are summed over
the inter tier after the intra scatter (the leftover psum of
``gspmd.make_train_step``).  Over an intra tier of one rank such a leaf
is replicated.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

#: stack depth of each top-level parameter group (the groups of every
#: ported family); any other top-level key is not stacked
STACK_DEPTH = {"layers": 1, "mamba": 2, "mamba_tail": 1, "shared_attn": 0,
               "enc_layers": 1, "dec_layers": 1}
#: the trunks of a family with two, in forward order (the audio
#: encoder-decoder's)
TWO_TRUNKS = ("enc_layers", "dec_layers")
#: stack depth of the moe family's super-layer containers under ``layers``
SUPER_DEPTH = {"moe": 1, "dense": 2}
_DIM0 = ("lm_head", "wq", "wk", "wv", "w_gate", "w_up", "in_proj", "router")
_DIM1 = ("embed", "wo", "w_down", "out_proj", "conv_w")
_EXPERT = ("w_up", "w_gate", "w_down")


class IntraDim(int):
    """The sharded dim of a leaf that shards over the intra tier of a
    two-tier layout only, into ``intra`` pieces."""

    def __new__(cls, dim: int, intra: int):
        obj = super().__new__(cls, dim)
        obj.intra = intra
        return obj

    def __repr__(self):
        return f"IntraDim({int(self)}, intra={self.intra})"


class Stationary(int):
    """The sharded dim of an expert leaf under weight-stationary expert
    parallelism: each rank holds its E/n experts, which are neither
    gathered nor scattered (the gradient of a rank's experts lands on its
    shard through the dispatch exchange's backward)."""

    def __repr__(self):
        return f"Stationary({int(self)})"


def shifted(d, k: int):
    """A sharded dim (or None) moved by k, keeping its kind."""
    if d is None:
        return None
    if isinstance(d, IntraDim):
        return IntraDim(d + k, d.intra)
    return type(d)(d + k)


def moves(d) -> bool:
    """Whether a leaf sharded on ``d`` is gathered and scattered (neither
    replicated nor stationary)."""
    return d is not None and not isinstance(d, Stationary)


def stack_depth(path: Sequence[str]) -> int:
    """Leading stacked-layer dims of the leaf at ``path`` (a key tuple)."""
    if len(path) > 2 and path[0] == "layers" and path[1] in SUPER_DEPTH:
        return SUPER_DEPTH[path[1]]
    return STACK_DEPTH.get(path[0], 0) if len(path) > 1 else 0


def is_expert(path: Sequence[str]) -> bool:
    """An expert bank of a moe block: ``w_up``, ``w_gate`` or ``w_down``
    under the parent key ``moe``."""
    return len(path) >= 2 and path[-2] == "moe" and path[-1] in _EXPERT


def stacked_groups(tree) -> List[str]:
    """The top-level keys of ``tree`` whose leaves are stacked, in sorted
    key order."""
    return [k for k in sorted(tree) if STACK_DEPTH.get(k, 0)
            and isinstance(tree[k], dict)]


def trunk_groups(tree) -> List[str]:
    """The stacked groups that the overlap schedule's prefetch and chained
    rings walk, each by its first stack dim, in forward order: the
    encoder-decoder's ``enc_layers`` then ``dec_layers``; else the deepest
    of ``tree``'s stacked groups alone (``layers``, or the hybrid's
    ``mamba``, by its super-layers)."""
    groups = stacked_groups(tree)
    if set(TWO_TRUNKS) <= set(groups):
        return list(TWO_TRUNKS)
    return [max(groups, key=STACK_DEPTH.get)]


def trunk_group(tree) -> str:
    """The one trunk of ``tree`` (``trunk_groups``); a tree of two trunks
    raises."""
    groups = trunk_groups(tree)
    if len(groups) != 1:
        raise ValueError(f"the tree has {len(groups)} trunks {groups}; "
                         f"name one")
    return groups[0]


def leaf_dim(path: Sequence[str], shape, n: int,
             intra: Optional[int] = None, ep: bool = False) -> Optional[int]:
    """The sharded dim of the leaf at ``path`` (a key tuple) with this
    full shape, or None when the leaf is replicated over n ranks.
    ``intra``: the intra tier's size under a two-tier layout of n ranks
    (the last rule's leaves then shard over it alone: ``IntraDim``).
    ``ep``: weight-stationary expert parallelism (the expert banks on
    their E dim, ``Stationary``)."""
    name = path[-1]
    stacked = stack_depth(path)
    logical = len(shape) - stacked
    if is_expert(path):
        if ep:
            dim = stacked
            if shape[dim] % n or shape[dim] < n:
                return None
            return Stationary(dim)
        d = 2 if name == "w_down" else 1
    elif name in _DIM0:
        d = 0
    elif name in _DIM1:
        d = 1
    else:
        d = logical - 1
        if intra is not None and intra != n:
            dim = stacked + d
            if intra == 1 or shape[dim] % intra or shape[dim] < intra:
                return None
            return IntraDim(dim, intra)
    dim = stacked + d
    if shape[dim] % n or shape[dim] < n:
        return None
    return dim


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def leaf_dims(params, n: int, intra: Optional[int] = None,
              ep: bool = False):
    """Tree of the sharded dim of every leaf (None = replicated)."""
    return _map(lambda p, x: leaf_dim(p, tuple(x.shape), n, intra, ep),
                params)


def layer_dims(dims, group: str = "layers", depth: Optional[int] = None):
    """The dims of one slice of ``group``'s stacked leaves, ``depth``
    stack dims in (default: all of each leaf's, one block: for the moe
    family's ``layers``, a tree of one moe block and one dense block)."""
    return _map(lambda p, d: shifted(
        d, -(stack_depth((group,) + p) if depth is None else depth)),
        dims[group])


def block_dims(dims) -> List[dict]:
    """The dims of one block of each stacked kind: a layer of ``layers``
    (the moe family: a moe block and a dense block), a mamba block of the
    hybrid's ``mamba`` and ``mamba_tail``, an encoder and a decoder block
    of the audio family's ``enc_layers`` and ``dec_layers``."""
    out = []
    for group in stacked_groups(dims):
        d = layer_dims(dims, group)
        if group == "layers" and set(d) <= set(SUPER_DEPTH):
            out += [d[k] for k in sorted(d)]
        else:
            out.append(d)
    return out


def top_dims(dims):
    """The dims of the leaves that are not stacked (``shared_attn``
    included)."""
    return {k: v for k, v in dims.items() if k not in stacked_groups(dims)}


def pieces(d, n: int) -> int:
    """How many distinct pieces n ranks hold of a leaf sharded on ``d``:
    1 replicated, ``intra`` for an ``IntraDim``, else n."""
    if d is None:
        return 1
    return d.intra if isinstance(d, IntraDim) else n


def shard_params(params, ranks, dims=None) -> List[dict]:
    """Full tree -> one shard tree per rank, each on its rank's device;
    ``dims`` defaults to the flat layout's ``leaf_dims``."""
    n = len(ranks.devices)
    if dims is None:
        dims = leaf_dims(params, n)

    def piece(r):
        def f(path, x):
            d = get(dims, path)
            if d is None:
                return x.detach().to(ranks.devices[r], copy=True)
            k = pieces(d, n)
            return x.detach().chunk(k, dim=d)[r % k].to(
                ranks.devices[r], copy=True).contiguous()
        return _map(f, params)

    return [piece(r) for r in range(n)]


def unshard_params(shards: Sequence[dict], dims, device="cpu"):
    """One shard tree per rank -> the full tree on ``device``, with
    ``dims`` the tree of sharded dims (``leaf_dims`` of the full tree); a
    replicated leaf is taken from rank 0, an ``IntraDim`` leaf from the
    first group."""
    def f(path, d):
        parts = [get(s, path).to(device)
                 for s in shards[:pieces(d, len(shards))]]
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
