"""The port's AdamW and learning-rate schedules against the JAX package's,
on the CPU.

Three steps of ``repro_torch.optim.adamw.adamw_update`` against
``repro.optim.adamw_update`` on the same parameters and gradient stream
(numpy from a seed), with and without the global-norm clip, weight decay
and a schedule's lr scale.  Tolerance: 1 ulp of float32 per element.  The
update is elementwise f32 in the same order of operations; only the pow in
the bias corrections may differ by an ulp between XLA and PyTorch.  The
global norm is a reduction whose sum order differs between the two (2 ulps
of m were seen through the clip scale), so the elementwise test hands both
the same norm, and the norm itself is held to 1e-6 relative.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as JConfig
from repro.optim import adamw_init as jinit
from repro.optim import adamw_update as jupdate
from repro.optim import cosine_schedule as jcosine
from repro.optim import linear_warmup as jwarmup
from repro_torch.optim import adamw as TA
from repro_torch.optim import schedules as TS

ULPS = 1


def _tree(rng):
    return {"w": rng.normal(size=(6, 7)).astype(np.float32),
            "layers": {"b": rng.normal(size=(3, 11)).astype(np.float32),
                       "a": rng.normal(size=(5,)).astype(np.float32)}}


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def _torch(tree):
    return TA.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


@pytest.mark.parametrize("clip,wd,sched", [
    (1.0, 0.0, None), (0.5, 0.1, "cosine"), (0.0, 0.0, "warmup"),
    (1e-3, 0.01, None)])
def test_adamw_three_steps_within_one_ulp(clip, wd, sched):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jcfg = JConfig(lr=1e-2, weight_decay=wd, grad_clip=clip)
    tcfg = TA.AdamWConfig(lr=1e-2, weight_decay=wd, grad_clip=clip)
    jp, tp = jax.tree.map(jnp.asarray, params), _torch(params)
    js, ts = jinit(jp), TA.adamw_init(tp)
    for _ in range(3):
        grads = jax.tree.map(lambda x: (3 * x).astype(np.float32),
                             _tree(rng))
        if sched == "cosine":
            jscale = jcosine(js["step"], 10, 2)
            tscale = TS.cosine_schedule(ts["step"], 10, 2)
        elif sched == "warmup":
            jscale = jwarmup(js["step"], 4)
            tscale = TS.linear_warmup(ts["step"], 4)
        else:
            jscale = tscale = 1.0
        norm = np.float32(np.sqrt(sum(np.sum(np.square(
            x.astype(np.float64))) for x in jax.tree.leaves(grads))))
        jp, js = jupdate(jcfg, jp, jax.tree.map(jnp.asarray, grads), js,
                         lr_scale=jscale, grad_norm=jnp.float32(norm))
        tp, ts = TA.adamw_update(tcfg, tp, _torch(grads), ts,
                                 lr_scale=tscale,
                                 grad_norm=torch.tensor(norm))
        assert int(ts["step"]) == int(js["step"])
        for key in ("m", "v"):
            for a, b in zip(jax.tree.leaves(js[key]),
                            TA.tree_leaves(ts[key])):
                assert _ulps(a, b.numpy()) <= ULPS
        for a, b in zip(jax.tree.leaves(jp), TA.tree_leaves(tp)):
            assert _ulps(a, b.numpy()) <= ULPS


def test_global_norm_and_external_norm():
    rng = np.random.default_rng(1)
    grads = _tree(rng)
    leaves = TA.tree_leaves(_torch(grads))
    ref = np.sqrt(sum(float(np.sum(np.square(x)))
                      for x in jax.tree.leaves(grads)))
    assert abs(float(TA.global_norm(leaves)) - ref) <= 1e-6 * ref
    # a norm passed in replaces the tree's own (shards of a larger tree)
    p = _torch(_tree(rng))
    cfg = TA.AdamWConfig(lr=1.0, grad_clip=1.0)
    a, _ = TA.adamw_update(cfg, p, _torch(grads), TA.adamw_init(p),
                           grad_norm=torch.tensor(1e6))
    b, _ = TA.adamw_update(cfg, p, _torch(grads), TA.adamw_init(p))
    assert not torch.equal(a["w"], b["w"])


@pytest.mark.parametrize("step", [0, 1, 3, 7, 12])
def test_schedules_match(step):
    s = jnp.int32(step)
    assert float(TS.linear_warmup(torch.tensor(step), 5)) == \
        float(jwarmup(s, 5))
    for total, warm in ((10, 0), (10, 3), (1, 0)):
        ours = float(TS.cosine_schedule(torch.tensor(step), total, warm))
        ref = float(jcosine(s, total, warm))
        assert _ulps(ours, ref) <= ULPS
