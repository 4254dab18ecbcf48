"""Carry trees of arrays between the JAX package and the port.

The JAX side hands over its parameters or caches as numpy arrays
(``jax.tree.map(np.asarray, params)``); ``params_from_numpy`` turns such a
nested dict into the port's dict of tensors, same keys, same stacked
``(L, ...)`` leaves, so both packages compute with the same weights.
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

