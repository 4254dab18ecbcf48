"""The gradient of the port's flash attention against the JAX package's,
on the CPU.

On a CUDA tensor ``repro_torch.kernels.flash_attention.flash_attention`` is
an autograd Function whose backward is ``flash_attention_bwd``, a port of
``repro.kernels.flash_attention.flash_attention_bwd_ref`` (the VJP of
``flash_attention_diff``).  Here that backward is held to
``flash_attention_bwd_ref`` and to ``jax.grad`` of ``flash_attention_diff``
in interpret mode, and the CPU route (autograd through the plain version)
to ``jax.grad`` as well, on the masking cases of ``tests/test_torch_cuda.py``
(causal, a decode row per batch, a window, a window with a softcap,
non-causal, GQA) and a packed row as ``pack_sequences`` lays it out.
Inputs and cotangents are numpy arrays from a seed.

Tolerance, float32: |diff| <= 1e-5 * (1 + |ref|): both sides sum the
softmax and the dk/dv contractions in different orders.  Every case has
at least one valid key in every query row (as training always does); a
fully masked row has no defined gradient.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import (flash_attention_bwd_ref,
                                           flash_attention_diff)
from repro_torch.data.packing import pack_sequences
from repro_torch.kernels import flash_attention as fa

TOL = 1e-5

# (B, S, T, H, KH, hd, options): the cases of tests/test_torch_cuda.py
CASES = {
    "causal": (2, 40, 40, 4, 2, 32, {}),
    "decode rows": (3, 1, 33, 4, 2, 32, {"last": [0, 20, 32]}),
    "window": (1, 45, 70, 4, 2, 64, {"window": 16}),
    "window+softcap": (2, 32, 32, 4, 2, 64,
                       {"logit_softcap": 50.0, "window": 12}),
    "non-causal": (2, 33, 33, 4, 1, 32, {"causal": False}),
}


def _case(name, seed=0):
    rng = np.random.default_rng(seed)
    if name == "packed":
        B, S, H, KH, hd = 1, 64, 4, 2, 32
        row = pack_sequences([np.zeros(n, np.int32) for n in (20, 30)], S)
        pos = row["positions"][None]
        seg = row["segment_ids"][None]
        kw = dict(q_positions=pos, kv_positions=pos, q_segment_ids=seg,
                  kv_segment_ids=seg)
        T = S
    else:
        B, S, T, H, KH, hd, opt = CASES[name]
        kw = dict(opt)
        last = kw.pop("last", None)
        qp = np.broadcast_to(T - S + np.arange(S), (B, S)).astype(np.int32)
        kp = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32).copy()
        if last is not None:
            last = np.asarray(last)
            qp = np.broadcast_to(last[:, None], (B, S)).astype(np.int32)
            kp[kp > last[:, None]] = -(10 ** 9)
        kw.update(q_positions=qp, kv_positions=kp)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, KH, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, KH, hd)).astype(np.float32)
    g = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    return q, k, v, g, kw


def _t(kw):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            if isinstance(v, np.ndarray) else v for k, v in kw.items()}


def _j(kw):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


def _close(ours, ref):
    ours = np.asarray(ours, np.float32)
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    err = np.abs(ours - ref)
    assert (err <= TOL * (1 + np.abs(ref))).all(), float(err.max())


def _jax_grads(q, k, v, g, kw):
    def f(q, k, v):
        out = flash_attention_diff(q, k, v, blk_q=16, blk_k=16,
                                   interpret=True, **_j(kw))
        return jnp.sum(out * g)
    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))


NAMES = list(CASES) + ["packed"]


@pytest.mark.parametrize("name", NAMES)
def test_backward_port_matches_bwd_ref(name):
    q, k, v, g, kw = _case(name)
    ref = flash_attention_bwd_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(g), **_j(kw))
    ours = fa.flash_attention_bwd(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), torch.from_numpy(g),
                                  **_t(kw))
    for a, b in zip(ours, ref):
        _close(a.numpy(), b)


@pytest.mark.parametrize("name", NAMES)
def test_grads_match_jax_grad_of_the_pallas_kernel(name):
    """``jax.grad`` through the interpret-mode kernel's custom VJP against
    the port's backward and the port's CPU route (autograd of the plain
    version)."""
    q, k, v, g, kw = _case(name, seed=1)
    ref = _jax_grads(q, k, v, g, kw)
    ours = fa.flash_attention_bwd(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), torch.from_numpy(g),
                                  **_t(kw))
    for a, b in zip(ours, ref):
        _close(a.numpy(), b)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    fa.flash_attention(qt, kt, vt, **_t(kw)).backward(torch.from_numpy(g))
    for a, b in zip((qt.grad, kt.grad, vt.grad), ref):
        _close(a.numpy(), b)
