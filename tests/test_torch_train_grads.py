"""The port's step-0 gradients against the JAX package, on the CPU.

Reduced qwen-1.5b, LongAlign lengths planned by LB-Mini, world 2 and 4
(the JAX side on the fake host devices of ``tests/conftest.py``, the port
with every rank on the CPU), the cases of ``tests/torch_train_cases.py``.

* Step-0 gradients of all six comm x schedule pairs against ``jax.grad``
  of the summed ``T.loss`` over every rank's microbatches divided by the
  global token count, leaf by leaf.  Tolerance: |diff| <= 1e-4 *
  max|ref| over the leaf: the gradient is a sum over tokens, microbatches
  and ranks that XLA and PyTorch take in different orders (f32 rounding,
  about 1e-6 of the leaf's scale), while a wrong gradient (a rank, a layer
  or the normalization missing) is off by O(1) of it.
* The step's gradient norm before clipping, and ``transformer.loss`` and
  its gradients on one microbatch (qwen, gemma2, gemma3 at 6 layers, phi3,
  minitron and chameleon).
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_reduced
from repro_torch.core import fsdp
from torch_train_cases import (GRAD_TOL, PAIRS, _get, _state,  # noqa: F401
                               _steps, _trainer, global_mean_grad,
                               jax_model, one_torch_thread, reduced_case)


@pytest.fixture(scope="module", params=[2, 4])
def step0(request, jax_model):
    """world, the step-0 batch, and jax.grad of the global mean loss."""
    world = request.param
    cfg, params = jax_model
    jb, tb, counts = _steps(world, 1)[0]
    return (world, tb, counts) + global_mean_grad(cfg, params, jb, world)


@pytest.mark.parametrize("comm,schedule", PAIRS)
def test_step0_gradients_match_jax_grad(step0, jax_model, comm, schedule):
    world, tb, counts, loss, tok, ref = step0
    tr = _trainer(world, comm, schedule)
    shards, _ = _state(jax_model, tr)
    grads, metrics = tr.grads(shards, tb, counts)
    assert float(metrics["tokens"]) == tok
    assert abs(float(metrics["loss"]) - loss) <= 1e-6 * abs(loss)
    full = tr.unshard(grads)
    for path, g in jax.tree_util.tree_leaves_with_path(ref):
        keys = tuple(k.key for k in path)
        g = np.asarray(g)
        ours = _get(full, keys).numpy()
        assert ours.shape == g.shape
        err = np.abs(ours - g).max()
        assert err <= GRAD_TOL * np.abs(g).max(), (keys, float(err))


@pytest.mark.parametrize("comm,schedule", PAIRS)
def test_step_reports_the_gradient_norm_before_clipping(jax_model, comm,
                                                        schedule):
    """``metrics["grad_norm"]`` is the global norm of the whole step-0
    gradient, each sharded leaf counted once.  Tolerance 1e-5 relative:
    an f32 sum of squares over every element in another order than the
    float64 reference."""
    _, tb, counts = _steps(2, 1)[0]
    tr = _trainer(2, comm, schedule)
    shards, opt = _state(jax_model, tr)
    grads, _ = tr.grads(shards, tb, counts)
    full = tr.unshard(grads)
    ref = sum(float(fsdp.get(full, p).double().square().sum())
              for p in fsdp.tree_paths(full)) ** 0.5
    _, _, m = tr.step(shards, opt, tb, counts)
    assert abs(float(m["grad_norm"]) - ref) <= 1e-5 * ref


@pytest.mark.parametrize("arch", ["qwen-1.5b", "gemma2-9b"])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_loss_and_gradients_match(arch, remat, reduction):
    """``transformer.loss`` and its gradients against the JAX ``T.loss``
    on one packed microbatch (gemma2: sliding window on alternate layers,
    attention and final soft-capping).  Same leaf-scaled tolerance as the
    train-step gradients; the loss within 1e-6 relative."""
    _loss_and_gradients(jconfigs.get_reduced(arch), get_reduced(arch),
                        remat, reduction)


@pytest.mark.parametrize("arch", ["gemma3-27b", "phi3-medium-14b",
                                  "minitron-8b", "chameleon-34b"])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_loss_and_gradients_match_other_dense_configs(arch, remat,
                                                      reduction):
    """The same for the other dense configs and the vlm family's
    chameleon (qk-norm); gemma3 at 6 layers, five ``local`` and one
    ``global``, so that its 5:1 pattern runs whole."""
    _loss_and_gradients(*reduced_case(arch), remat, reduction)


def _loss_and_gradients(cfg, tcfg, remat, reduction):
    from repro_torch.models import transformer as TT

    params = JT.init_params(cfg, jax.random.PRNGKey(1))
    jb, tb, _ = _steps(2, 1)[0]
    mb = {k: v[0, 0:1] for k, v in jb.items()}
    (ref, jm), jg = jax.value_and_grad(
        lambda p: JT.loss(cfg, p, mb, remat=remat, reduction=reduction),
        has_aux=True)(params)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    for path in fsdp.tree_paths(tp):
        fsdp.get(tp, path).requires_grad_(True)
    tmb = {k: torch.from_numpy(np.ascontiguousarray(v[0, 0:1]))
           for k, v in tb.items()}
    ours, tm = TT.loss(tcfg, tp, tmb, remat=remat, reduction=reduction)
    ours.backward()
    assert float(tm["tokens"]) == float(jm["tokens"])
    assert abs(ours.item() - float(ref)) <= 1e-6 * abs(float(ref))
    for path, g in jax.tree_util.tree_leaves_with_path(jg):
        keys = tuple(k.key for k in path)
        g = np.asarray(g)
        err = np.abs(fsdp.get(tp, keys).grad.numpy() - g).max()
        assert err <= GRAD_TOL * np.abs(g).max(), (cfg.name, keys,
                                                     float(err))
