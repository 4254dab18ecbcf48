"""The port's train step for the moe family (reduced grok-1-314b and
llama4-maverick-400b-a17b, 2 ranks on the CPU) against the JAX package.

* The layout: ``fsdp.leaf_dims`` equals the data-axis dim of
  ``gspmd.param_pspecs`` for every leaf, on 2 and 4 ranks, with
  ``moe_ep`` 'none' (experts on d, router on d, ``layers/moe`` one stack
  dim and ``layers/dense`` two) and 'data' (experts on E, stationary).
* Two train steps of the ``Trainer`` under collective x layer, odc x
  minibatch and odc-overlap against the JAX ``make_train_step`` on a
  2-device mesh, the losses within LOSS_RTOL and the token counts equal
  (grok against the JAX step of each config; llama4, whose batches carry
  the vision stub's embeddings, and grok with ``moe_groups`` 2, against
  the collective x layer step, the JAX configs' losses agreeing among
  themselves), and the step-0
  gradients of every config, expert parallelism included, against
  ``jax.grad`` of the global mean loss, padding microbatches' router loss
  included (``tests/test_torch_train_grads.py``'s tolerance).
* Weight-stationary expert parallelism against the port's baseline
  within ``tests/test_moe_ep.py``'s bounds (loss within 1e-5, every
  parameter within 2e-3 after one step at lr 1e-2, capacity factor 8).
* The refusals: cp and the two-tier backends (``resolve`` and the train
  driver), expert parallelism under the overlap schedule, an unknown
  ``moe_ep``; and ``bridge.train_state_from_numpy`` of the nested trees.

One torch thread per test.
"""
import dataclasses
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.core.gspmd import (GSPMDConfig, ShardingRules, make_train_step,
                              param_pspecs)
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as jinit
from repro_torch import bridge
from repro_torch.configs import get_reduced
from repro_torch.core import backend as B
from repro_torch.core import fsdp
from repro_torch.core.ranks import RankGroup
from repro_torch.core.train_step import Trainer
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as TT
from repro_torch.optim.adamw import AdamWConfig
from torch_train_cases import (GRAD_TOL, LOSS_RTOL, LR, _get, _steps,
                               global_mean_grad, one_torch_thread)  # noqa

ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b")
CONFIGS = [("collective", "layer"), ("odc", "minibatch"),
           ("odc-overlap", "overlap")]


def _jax_params(arch, **over):
    cfg = dataclasses.replace(jconfigs.get_reduced(arch), **over)
    return cfg, JT.init_params(cfg, jax.random.PRNGKey(0))


def _vision(cfg, step, shape):
    """The train driver's vision stub: per-step seeded embeddings."""
    rng = np.random.RandomState(step)
    return rng.randn(*shape, cfg.frontend_tokens, cfg.d_model).astype(
        np.float32)


def _batches(cfg, n):
    """n steps of (JAX batch, port batch, counts) for 2 ranks, with the
    vision stub's embeddings in both when the config has them."""
    out = []
    for i, (jb, tb, counts) in enumerate(_steps(2, n)):
        if cfg.frontend == "vision" and cfg.frontend_tokens:
            ve = _vision(cfg, i, jb["tokens"].shape[:2])
            jb, tb = dict(jb, vision_embeds=ve), dict(tb, vision_embeds=ve)
        out.append((jb, tb, counts))
    return out


def _trainer(arch, comm, schedule, world=2, lr=LR, **kw):
    cfg = dataclasses.replace(get_reduced(arch), **kw.pop("cfg", {}))
    return Trainer(cfg, RankGroup.make(world, "cpu"), comm=comm,
                   schedule=schedule, opt_cfg=AdamWConfig(lr=lr), **kw)


def _state(params, trainer):
    return bridge.train_state_from_numpy(
        jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, jinit(params)), trainer)


# ===========================================================================
# the layout
# ===========================================================================
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("ep", ["none", "data"])
def test_leaf_dims_follow_param_pspecs(arch, n, ep):
    cfg = jconfigs.get_reduced(arch)
    shapes = jax.eval_shape(lambda k: JT.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    specs = param_pspecs(cfg, shapes, ShardingRules(),
                         make_host_mesh(data=n), moe_ep=ep)
    dims = fsdp.leaf_dims(TT.param_shapes(get_reduced(arch)), n,
                          ep=ep == "data")
    seen = set()
    for path, spec in jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda s: isinstance(s, P)):
        keys = tuple(k.key for k in path)
        at = [i for i, e in enumerate(spec) if e == "data"]
        got = fsdp.get(dims, keys)
        assert got == (at[0] if at else None), keys
        assert isinstance(got, fsdp.Stationary) == (
            ep == "data" and fsdp.is_expert(keys)), keys
        seen.add(keys)
    assert seen == set(fsdp.tree_paths(dims))
    assert fsdp.get(dims, ("layers", "moe", "moe", "router")) == 1
    assert fsdp.get(dims, ("layers", "moe", "moe", "w_down")) == (
        1 if ep == "data" else 3)
    if "dense" in dims["layers"]:
        assert fsdp.get(dims, ("layers", "dense", "mlp", "w_up")) == 2
        assert fsdp.get(dims, ("layers", "moe", "shared_mlp", "w_up")) == 1


# ===========================================================================
# the train step against the JAX engine
# ===========================================================================
@pytest.fixture(scope="module")
def jax_losses():
    """(arch, comm, schedule, moe_groups) -> the JAX engine's two (loss,
    tokens)."""
    done = {}

    def get(arch, comm, schedule, groups=0):
        if arch != ARCHS[0] or groups:  # the collective x layer engine
            comm, schedule = CONFIGS[0]
        key = (arch, comm, schedule, groups)
        if key not in done:
            cfg, params = _jax_params(arch)
            mesh = make_host_mesh(data=2)
            rep = NamedSharding(mesh, P())
            step = jax.jit(make_train_step(cfg, mesh, GSPMDConfig(
                rules=ShardingRules(), comm=comm, schedule=schedule,
                moe_groups=groups), JAdamW(lr=LR)), out_shardings=rep)
            jp, jo = jax.device_put((params, jinit(params)), rep)
            out = []
            for jb, _, _ in _batches(cfg, 2):
                with mesh:
                    jp, jo, m = step(jp, jo, jb)
                out.append((float(m["loss"]), float(m["tokens"])))
            done[key] = out
        return done[key]

    return get


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("comm,schedule", CONFIGS)
def test_two_steps_match_the_jax_engine(jax_losses, arch, comm, schedule):
    cfg, params = _jax_params(arch)
    tr = _trainer(arch, comm, schedule)
    shards, opt = _state(params, tr)
    for (_, tb, counts), (ref, tok) in zip(_batches(cfg, 2),
                                           jax_losses(arch, comm, schedule)):
        shards, opt, m = tr.step(shards, opt, tb, counts)
        assert float(m["tokens"]) == tok
        assert abs(float(m["loss"]) - ref) <= LOSS_RTOL * abs(ref)


@pytest.mark.parametrize("comm,schedule", CONFIGS)
def test_dispatch_groups_match_the_jax_engine(jax_losses, comm, schedule):
    """``moe_groups`` 2 (``GSPMDConfig.moe_groups``) through the trunk and
    the train step of each config: each microbatch row's tokens dispatch
    as two groups of half the capacity, which drops other tokens than one
    group a row (the losses move), the same as the JAX collective x layer
    step with ``moe_groups`` 2 (the JAX configs agree among themselves,
    as ``test_two_steps_match_the_jax_engine`` shows for one group)."""
    arch = ARCHS[0]
    cfg, params = _jax_params(arch)
    tr = _trainer(arch, comm, schedule, moe_groups=2)
    shards, opt = _state(params, tr)
    ref = jax_losses(arch, comm, schedule, 2)
    assert ref != jax_losses(arch, *CONFIGS[0])
    for (_, tb, counts), (want, tok) in zip(_batches(cfg, 2), ref):
        shards, opt, m = tr.step(shards, opt, tb, counts)
        assert float(m["tokens"]) == tok
        assert abs(float(m["loss"]) - want) <= LOSS_RTOL * abs(want)


@pytest.fixture(scope="module")
def step0():
    """arch -> (port batch, counts, loss, tokens, jax.grad of the global
    mean loss over every rank's microbatches, padding ones included)."""
    done = {}

    def get(arch):
        if arch not in done:
            cfg, params = _jax_params(arch)
            jb, tb, counts = _batches(cfg, 1)[0]
            done[arch] = (tb, counts) + global_mean_grad(cfg, params, jb, 2)
        return done[arch]

    return get


@pytest.mark.parametrize("comm,schedule,ep", [
    ("collective", "layer", "none"), ("odc", "minibatch", "none"),
    ("odc-overlap", "overlap", "none"), ("collective", "layer", "data"),
    ("odc", "minibatch", "data")])
def test_step0_gradients_match_jax_grad(step0, comm, schedule, ep):
    arch = ARCHS[0]
    tb, counts, loss, tok, ref = step0(arch)
    _, params = _jax_params(arch)
    tr = _trainer(arch, comm, schedule, moe_ep=ep)
    assert tr.ep == (ep == "data")
    shards, _ = _state(params, tr)
    grads, metrics = tr.grads(shards, tb, counts)
    assert float(metrics["tokens"]) == tok
    assert abs(float(metrics["loss"]) - loss) <= 1e-6 * abs(loss)
    full = tr.unshard(grads)
    for path, g in jax.tree_util.tree_leaves_with_path(ref):
        keys = tuple(k.key for k in path)
        g = np.asarray(g)
        err = np.abs(_get(full, keys).numpy() - g).max()
        assert err <= GRAD_TOL * np.abs(g).max(), (keys, float(err))


# ===========================================================================
# weight-stationary expert parallelism against the baseline
# ===========================================================================
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("comm,schedule", [("collective", "layer"),
                                           ("odc", "minibatch")])
def test_expert_parallel_matches_the_baseline(arch, comm, schedule):
    """tests/test_moe_ep.py's bounds: capacity factor 8 (no drops), one
    step at lr 1e-2, the loss within 1e-5 and every parameter within
    2e-3; and the expert banks never gathered or scattered."""
    _, params = _jax_params(arch, moe_capacity_factor=8.0)
    cfg8 = {"moe_capacity_factor": 8.0}
    _, tb, counts = _batches(jconfigs.get_reduced(arch), 1)[0]
    out = {}
    for ep in ("none", "data"):
        tr = _trainer(arch, comm, schedule, lr=1e-2, moe_ep=ep, cfg=cfg8)
        shards, opt = _state(params, tr)
        moved = []
        gather = tr.backend.gather_dim
        tr.backend.gather_dim = lambda xs, d, o=None: (
            moved.append(tuple(xs[0].shape)), gather(xs, d, o))[1]
        try:
            shards, _, m = tr.step(shards, opt, tb, counts)
        finally:
            del tr.backend.gather_dim
        out[ep] = (float(m["loss"]), tr.unshard(shards), moved)
    (l0, p0, moved0), (l1, p1, moved1) = out["none"], out["data"]
    assert abs(l0 - l1) < 1e-5
    dp = max(float((fsdp.get(p0, k) - fsdp.get(p1, k)).abs().max())
             for k in fsdp.tree_paths(p0))
    assert dp < 2e-3, dp
    # the expert banks' gathers are all that expert parallelism drops:
    # once a step under 'minibatch', per block in the forward and in the
    # recompute of each microbatch under 'layer'
    cfg = get_reduced(arch)
    banks = sum(fsdp.is_expert(p) for p in fsdp.tree_paths(p0))
    per_step = 1 if schedule == "minibatch" else \
        2 * tb["tokens"].shape[0] * (cfg.num_layers // cfg.moe_period)
    assert len(moved0) - len(moved1) == banks * per_step


# ===========================================================================
# refusals and state
# ===========================================================================
@pytest.mark.parametrize("comm", ["cp", "hier", "pipe", "pipe-int8"])
def test_cp_and_two_tier_backends_refuse_the_family(comm, capsys):
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        B.resolve(comm, "minibatch", moe=True)
    with pytest.raises(NotImplementedError, match="item 12"):
        _trainer(ARCHS[0], comm, "minibatch", world=4,
                 **({"cp": 2} if comm == "cp" else {}))
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--arch", ARCHS[1], "--reduced", "--device",
                              "cpu", "--comm", comm, "--data-axis", "4"])
    assert "queue 1 item 12" in capsys.readouterr().err


def test_expert_parallelism_refuses_the_overlap_schedule():
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        _trainer(ARCHS[0], "odc-overlap", "overlap", moe_ep="data")
    with pytest.raises(ValueError, match="moe_ep"):
        _trainer(ARCHS[0], "odc", "minibatch", moe_ep="model")
    # E = 4 over 3 ranks: expert parallelism falls back to gathering
    tr = _trainer(ARCHS[0], "odc-overlap", "overlap", world=3,
                  moe_ep="data")
    assert not tr.ep


@pytest.mark.parametrize("ep", ["none", "data"])
def test_train_state_from_numpy_of_nested_trees(ep):
    arch = ARCHS[1]
    _, params = _jax_params(arch)
    tr = _trainer(arch, "odc", "minibatch", moe_ep=ep)
    np_params = jax.tree.map(np.asarray, params)
    opt = jax.tree.map(np.asarray, jinit(params))
    opt["m"] = jax.tree.map(lambda x: x + 1.0, opt["m"])
    shards, opts = bridge.train_state_from_numpy(np_params, opt, tr)
    w = fsdp.get(shards[0], ("layers", "moe", "moe", "w_up"))
    assert w.shape[1 if ep == "data" else 2] * 2 == \
        np_params["layers"]["moe"]["moe"]["w_up"].shape[
            1 if ep == "data" else 2]
    state = tr.state_tree(shards, opts)
    for path in fsdp.tree_paths(state["params"]):
        np.testing.assert_array_equal(
            fsdp.get(state["params"], path).numpy(),
            fsdp.get(np_params, path))
        np.testing.assert_array_equal(
            fsdp.get(state["opt"]["m"], path).numpy(),
            fsdp.get(opt["m"], path))
