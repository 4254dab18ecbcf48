"""The port's train step for the audio family (reduced
seamless-m4t-medium, 2 ranks on the CPU) against the JAX package.

* The layout: ``fsdp.leaf_dims`` equals the data-axis dim of
  ``gspmd.param_pspecs`` for every leaf of the reduced and the full tree
  (``enc_layers`` and ``dec_layers`` one stack dim each, the decoder's
  ``cross`` and ``cross_norm`` included), on 2 and 4 ranks; the overlap
  schedule's trunks are both stacks, the encoder's first.
* Two train steps of the ``Trainer`` under collective x layer, odc x
  minibatch and odc-overlap against the JAX ``make_train_step`` of the
  same config on a 2-device mesh, each step's batch carrying the train
  driver's frame stub: the losses within LOSS_RTOL and the token counts
  equal; the step-0 gradients of each config against ``jax.grad`` of the
  global mean loss (``tests/test_torch_train_grads.py``'s tolerance);
  under odc-overlap, two chained gathers and two chained scatters a
  microbatch round.
* Save -> resume through the train driver under odc-overlap: the losses
  and final parameters bitwise those of 3 steps run straight; the train
  state crosses between the packages' checkpoints bitwise.
* The refusals: cp and the two-tier backends (``resolve``, the Trainer
  and the train driver, naming queue 1 item 14).

One torch thread per test.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import numpy as np
import pytest
import torch
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
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import backend as B
from repro_torch.core import fsdp, overlap
from repro_torch.core.ranks import RankGroup
from repro_torch.core.train_step import Trainer
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as TT
from repro_torch.optim.adamw import AdamWConfig
from torch_train_cases import (GRAD_TOL, LOSS_RTOL, LR, _get, _steps,
                               global_mean_grad, one_torch_thread)  # noqa

ARCH = "seamless-m4t-medium"
CONFIGS = [("collective", "layer"), ("odc", "minibatch"),
           ("odc-overlap", "overlap")]


@pytest.fixture(scope="module")
def jax_model():
    cfg = jconfigs.get_reduced(ARCH)
    return cfg, JT.init_params(cfg, jax.random.PRNGKey(0))


def _batches(cfg, n):
    """n steps of (JAX batch, port batch, counts) for 2 ranks, each with
    the train driver's frames: ``RandomState(step).randn(M, W, 16, d)``."""
    out = []
    for i, (jb, tb, counts) in enumerate(_steps(2, n)):
        enc = np.random.RandomState(i).randn(
            *jb["tokens"].shape[:2], 16, cfg.d_model).astype(np.float32)
        out.append((dict(jb, encoder_embeds=enc),
                    dict(tb, encoder_embeds=enc), counts))
    return out


def _trainer(comm, schedule, world=2, **kw):
    return Trainer(get_reduced(ARCH), RankGroup.make(world, "cpu"),
                   comm=comm, schedule=schedule, opt_cfg=AdamWConfig(lr=LR),
                   **kw)


def _state(params, trainer):
    return bridge.train_state_from_numpy(
        jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, jinit(params)), trainer)


# ===========================================================================
# the layout
# ===========================================================================
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_leaf_dims_follow_param_pspecs(full, n):
    cfg = (jconfigs.get_config if full else jconfigs.get_reduced)(ARCH)
    shapes = jax.eval_shape(lambda k: JT.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    specs = param_pspecs(cfg, shapes, ShardingRules(),
                         make_host_mesh(data=n))
    tshapes = TT.param_shapes((get_config if full else get_reduced)(ARCH))
    dims = fsdp.leaf_dims(tshapes, n)
    seen = set()
    for path, spec in jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda s: isinstance(s, P)):
        keys = tuple(k.key for k in path)
        at = [i for i, e in enumerate(spec) if e == "data"]
        assert fsdp.get(dims, keys) == (at[0] if at else None), keys
        assert tuple(fsdp.get(tshapes, keys).shape) == \
            fsdp.get(shapes, keys).shape, keys
        seen.add(keys)
    assert seen == set(fsdp.tree_paths(dims))
    assert fsdp.get(dims, ("dec_layers", "cross", "wk")) == 1
    assert fsdp.get(dims, ("dec_layers", "cross", "wo")) == 2
    assert fsdp.get(dims, ("dec_layers", "cross_norm")) == 1
    assert fsdp.get(dims, ("enc_final_norm",)) == 0
    assert fsdp.trunk_groups(dims) == ["enc_layers", "dec_layers"]
    with pytest.raises(ValueError, match="2 trunks"):
        fsdp.trunk_group(dims)
    if full:
        total = sum(fsdp.get(tshapes, p).numel()
                    for p in fsdp.tree_paths(tshapes))
        assert total == 614_739_968


# ===========================================================================
# the train step against the JAX engine
# ===========================================================================
@pytest.mark.parametrize("comm,schedule", CONFIGS)
def test_two_steps_match_the_jax_engine(jax_model, comm, schedule):
    cfg, params = jax_model
    mesh = make_host_mesh(data=2)
    rep = NamedSharding(mesh, P())
    step = jax.jit(make_train_step(cfg, mesh, GSPMDConfig(
        rules=ShardingRules(), comm=comm, schedule=schedule),
        JAdamW(lr=LR)), out_shardings=rep)
    jp, jo = jax.device_put((params, jinit(params)), rep)
    tr = _trainer(comm, schedule)
    shards, opt = _state(params, tr)
    for jb, tb, counts in _batches(cfg, 2):
        with mesh:
            jp, jo, jm = step(jp, jo, jb)
        shards, opt, m = tr.step(shards, opt, tb, counts)
        ref = float(jm["loss"])
        assert float(m["tokens"]) == float(jm["tokens"])
        assert abs(float(m["loss"]) - ref) <= LOSS_RTOL * abs(ref)


@pytest.fixture(scope="module")
def step0(jax_model):
    """(port batch, counts, loss, tokens, jax.grad of the global mean
    loss over every rank's microbatches)."""
    cfg, params = jax_model
    jb, tb, counts = _batches(cfg, 1)[0]
    return (tb, counts) + global_mean_grad(cfg, params, jb, 2)


@pytest.mark.parametrize("comm,schedule", CONFIGS)
def test_step0_gradients_match_jax_grad(jax_model, step0, comm, schedule,
                                        monkeypatch):
    _, params = jax_model
    tb, counts, loss, tok, ref = step0
    tr = _trainer(comm, schedule)
    calls = {"gather": 0, "scatter": 0}
    for name, mod, key in (("odc_gather_layers", overlap.kgather, "gather"),
                           ("odc_scatter_accumulate_layers",
                            overlap.kscatter, "scatter")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
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
    # the overlap schedule chains both trunks: each round gathers the
    # encoder's and the decoder's, and scatters both
    rounds = tb["tokens"].shape[0]
    chained = 2 * rounds if comm == "odc-overlap" else 0
    assert calls == {"gather": chained, "scatter": chained}
    if comm == "odc-overlap":
        assert tr.chain.groups == ["enc_layers", "dec_layers"]


def test_save_then_resume_is_bitwise(tmp_path):
    def run(*extra):
        return train_cli.run(train_cli.parse_args(
            ["--arch", ARCH, "--reduced", "--device", "cpu", "--data-axis",
             "2", "--comm", "odc-overlap", "--max-tokens", "128",
             "--max-len", "120", "--quiet", *extra]), return_params=True)

    ckpt = str(tmp_path / "ckpt")
    straight = run("--steps", "3")
    first = run("--steps", "2", "--ckpt-dir", ckpt, "--save-every", "2")
    assert first["saved"] == [2]
    resumed = run("--steps", "3", "--ckpt-dir", ckpt, "--resume")
    assert resumed["start_step"] == 2 and len(resumed["losses"]) == 1
    assert first["losses"] + resumed["losses"] == straight["losses"]
    assert all(np.isfinite(straight["losses"]))
    for path in fsdp.tree_paths(straight["params"]):
        assert torch.equal(fsdp.get(straight["params"], path),
                           fsdp.get(resumed["params"], path)), path


def test_checkpoints_cross_between_the_packages(tmp_path, jax_model):
    """The encoder-decoder's train state (``enc_layers``, ``dec_layers``
    with ``cross``) written by ``repro.checkpoint`` loads into the port
    bitwise, and the port writes the same files and manifest."""
    import json

    from repro import checkpoint as jckpt
    from repro_torch import checkpoint as tckpt

    _, params = jax_model
    state = {"params": params,
             "opt": {"m": jax.tree.map(lambda x: x * 0.5, params),
                     "v": jax.tree.map(lambda x: x * x, params),
                     "step": jinit(params)["step"] + 3}}
    d_jax, d_port = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_checkpoint(d_jax, 5, state)
    tr = _trainer("odc", "minibatch")
    tree = tckpt.load_checkpoint(d_jax, 5, tr.state_like())
    for path, leaf in jax.tree_util.tree_leaves_with_path(state):
        keys = tuple(k.key for k in path)
        np.testing.assert_array_equal(np.asarray(fsdp.get(tree, keys)),
                                      np.asarray(leaf))
    shards, opt = tr.restore(tree)
    tckpt.save_checkpoint(d_port, 5, tr.state_tree(shards, opt))
    assert sorted(os.listdir(d_port)) == sorted(os.listdir(d_jax))
    manifest = "state_00000005.json"
    with open(os.path.join(d_port, manifest)) as a, \
            open(os.path.join(d_jax, manifest)) as b:
        assert json.load(a) == json.load(b)
    back = jckpt.load_checkpoint(d_port, 5, state)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ===========================================================================
# refusals
# ===========================================================================
@pytest.mark.parametrize("comm", ["cp", "hier", "pipe", "pipe-int8"])
def test_cp_and_two_tier_backends_refuse_the_family(comm, capsys):
    with pytest.raises(NotImplementedError, match="queue 1 item 14"):
        B.resolve(comm, "minibatch", audio=True)
    with pytest.raises(NotImplementedError, match="item 14"):
        _trainer(comm, "minibatch", world=4,
                 **({"cp": 2} if comm == "cp" else {}))
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--arch", ARCH, "--reduced", "--device",
                              "cpu", "--comm", comm, "--data-axis", "4"])
    assert "queue 1 item 14" in capsys.readouterr().err
    tok = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="item 14"):
        TT.require_cp(get_reduced(ARCH))
    params = TT.init_params(get_reduced(ARCH), torch.Generator())
    with pytest.raises(NotImplementedError, match="item 14"):
        TT.loss_ranks(get_reduced(ARCH), [params, params],
                      [{"tokens": tok, "targets": tok}] * 2, cp=2)
