"""The port's train step against the JAX engine, on the CPU.

Reduced qwen-1.5b, LongAlign lengths planned by LB-Mini, world 2 and 4,
the cases of ``tests/torch_train_cases.py``; JAX weights and AdamW state
cross over through ``repro_torch.bridge``.

* Three-step losses against ``gspmd.make_train_step`` for collective x
  layer and ODC x minibatch.  Tolerance: 1e-5 relative.  The forward
  matches to f32 rounding, and AdamW's first steps move each weight by
  about lr * sign(g), so a gradient element whose sign flips under
  another summation order moves by up to 2 * lr (lr = 1e-3), which
  changes the loss by far less than 1e-5 of itself.
* ODC against collective in the port: equal step-0 losses (the same
  forward, tolerance 0), later losses within the same 1e-5.
* A device profile reorders the ODC rings, not the result.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import pytest

from repro.core.gspmd import GSPMDConfig, make_train_step
from repro.launch.mesh import make_host_mesh
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as jinit
from repro_torch.configs import get_reduced
from repro_torch.core import fsdp
from repro_torch.core.ranks import RankGroup
from repro_torch.core.train_step import Trainer
from torch_train_cases import (ARCH, GRAD_TOL, LOSS_RTOL, LR, MAX_TOKENS,  # noqa: F401
                               PAIRS, _state, _steps, _trainer, jax_model,
                               one_torch_thread)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("comm,schedule", PAIRS[:2])
def test_three_step_losses_match_the_jax_engine(jax_model, world, comm,
                                                schedule):
    cfg, params = jax_model
    mesh = make_host_mesh(data=world, model=1)
    step = jax.jit(make_train_step(
        cfg, mesh, GSPMDConfig(comm=comm, schedule=schedule,
                               block_kv=MAX_TOKENS), JAdamW(lr=LR)))
    tr = _trainer(world, comm, schedule)
    shards, opt = _state(jax_model, tr)
    jp, jo = params, jinit(params)
    for jb, tb, counts in _steps(world, 3):
        with mesh:
            jp, jo, jm = step(jp, jo, jb)
        shards, opt, tm = tr.step(shards, opt, tb, counts)
        ref = float(jm["loss"])
        assert abs(float(tm["loss"]) - ref) <= LOSS_RTOL * abs(ref)
        assert float(tm["tokens"]) == float(jm["tokens"])
    assert int(opt[0]["step"]) == 3


@pytest.mark.parametrize("world", [2, 4])
def test_odc_against_collective(jax_model, world):
    losses = {}
    for comm, schedule in PAIRS:
        tr = _trainer(world, comm, schedule)
        shards, opt = _state(jax_model, tr)
        losses[comm, schedule] = []
        for _, tb, counts in _steps(world, 3):
            shards, opt, m = tr.step(shards, opt, tb, counts)
            losses[comm, schedule].append(float(m["loss"]))
    ref = losses["collective", "layer"]
    for key, ls in losses.items():
        assert ls[0] == ref[0], key
        for a, b in zip(ls[1:], ref[1:]):
            assert abs(a - b) <= LOSS_RTOL * abs(b), key


@pytest.mark.parametrize("world", [2, 4])
def test_profile_ordered_rings_keep_the_step(jax_model, world):
    """A DeviceProfile reorders the ODC rings, not the result: the same
    loss, and gradients within the summation-order tolerance above."""
    from repro_torch.balance.cost import make_straggler_profile

    _, tb, counts = _steps(world, 1)[0]
    out = {}
    for prof in (None, make_straggler_profile("uniform", world, seed=0)):
        tr = Trainer(get_reduced(ARCH), RankGroup.make(world, "cpu"),
                     comm="odc", schedule="minibatch", device_profile=prof)
        assert (tr.order is None) == (prof is None)
        shards, _ = _state(jax_model, tr)
        grads, m = tr.grads(shards, tb, counts)
        out[prof is None] = (float(m["loss"]), tr.unshard(grads))
    (la, ga), (lb, gb) = out[True], out[False]
    assert la == lb
    for path in fsdp.tree_paths(ga):
        a, b = fsdp.get(ga, path), fsdp.get(gb, path)
        assert (a - b).abs().max() <= GRAD_TOL * b.abs().max()


