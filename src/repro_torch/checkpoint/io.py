"""Checkpoint save and restore, the counterpart of ``repro.checkpoint.io``
without jax: one ``.npz`` of the state and a JSON manifest, with the same
file names (``{name}_{step:08d}_host0.npz``, ``{name}_{step:08d}.json``),
the same ``/``-joined keys (dict keys in sorted order at every level) and
the same manifest, so a checkpoint written by either package loads in the
other.  The port holds every rank in one process, so it writes as host 0
of 1; the train driver saves the unsharded tree ``{"params": ...,
"opt": {"m": ..., "v": ..., "step": ...}}`` (``Trainer.state_tree``).

Leaves may be tensors, numpy arrays or numbers; they are written as numpy
arrays in their own dtype (float32 and the integer types; numpy has no
bfloat16), and ``load_checkpoint`` returns numpy arrays.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

HOST = 0
NUM_HOSTS = 1


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Leaves keyed as ``jax.tree_util.tree_flatten_with_path`` keys a
    tree of dicts: keys joined by ``/``, sorted at every level."""
    if isinstance(tree, dict):
        flat = {}
        for k in sorted(tree):
            flat.update(_flatten(tree[k], f"{prefix}{k}/"))
        return flat
    return {prefix[:-1]: tree}


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("save_checkpoint: numpy has no bfloat16; cast "
                            "the state to float32 first")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str, step: int, tree, *, name: str = "state"):
    os.makedirs(directory, exist_ok=True)
    arrays, meta = {}, {}
    for k, v in _flatten(tree).items():
        arr = _to_numpy(v)
        arrays[k] = arr
        meta[k] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
    path = os.path.join(directory, f"{name}_{step:08d}_host{HOST}.npz")
    np.savez(path, **arrays)
    manifest = {
        "step": step, "name": name, "host": HOST,
        "num_hosts": NUM_HOSTS, "leaves": meta,
    }
    with open(os.path.join(directory, f"{name}_{step:08d}.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return path


def latest_step(directory: str, name: str = "state") -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for fn in os.listdir(directory):
        if fn.startswith(f"{name}_") and fn.endswith(".json"):
            steps.append(int(fn[len(name) + 1: len(name) + 9]))
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: int, tree_like, *,
                    name: str = "state"):
    """The saved leaves, as numpy arrays, in the structure of
    ``tree_like`` (a tree of dicts whose leaves may be anything: only its
    keys are read)."""
    path = os.path.join(directory, f"{name}_{step:08d}_host{HOST}.npz")
    with np.load(path) as data:
        flat = {k: data[k] for k in _flatten(tree_like)}

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        return flat[prefix[:-1]]

    return rebuild(tree_like)
