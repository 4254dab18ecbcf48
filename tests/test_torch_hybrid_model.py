"""The port's hybrid family (zamba2-1.2b, reduced to 5 layers at period 2:
two super-layers of two mamba blocks, each followed by the shared dense
block, and a tail of one block; d_model 128, 4/2 heads of 32, ssm heads
of 32, state 16, chunk 32) against the JAX package, on the CPU.  The
reduced CLI config (2 layers) has no tail and one invocation of the
shared block, so every test here builds its own 5-layer config.

* ``transformer.param_shapes`` against ``init_params`` of both packages;
  the sharded dim of every leaf against ``gspmd.param_pspecs``, flat (2
  and 4 ranks) and two-tier (2 x 2 as hier and as pipe); the per-group
  stack rule leaves qwen's and mamba2's dims as the single ``layers``
  rule gave them.
* ``transformer.apply``: prefill into a fresh cache and two decode steps,
  the logits against the JAX ``T.apply`` within 1e-5 relative, and every
  cache (mamba, attention per invocation, tail) within 1e-5 of 1 + its
  largest |ref| (the k and v of the second invocation come through five
  blocks of f32 sums in another order: 1.7e-5 off on an element of 0.2).
* ``transformer.loss`` and its gradient on one packed microbatch: the
  loss within 1e-6 relative, each leaf's gradient within GRAD_TOL of the
  leaf's largest |ref| (f32 sums over the tokens in another order): 1e-5
  at 2 layers; 2e-5 at 5, where each package's f32 gradient is itself up
  to 1.16e-5 (the port) and 1.14e-5 (JAX) of the leaf's largest |g| from
  the gradient of the port's forward in float64 on the same weights
  (``test_float32_gradients_match_float64`` holds both to it), so the two
  may differ by the sum.
* The train step's step-0 gradients under every comm x schedule the port
  runs for the family, against ``jax.grad`` of the global mean loss, as
  ``tests/test_torch_train_grads.py`` holds qwen's; the shared block's
  gradient sums its invocations before the one scatter.
* The wave engine's greedy tokens against the JAX ``GenerationEngine``'s;
  the serve driver end to end; the refusals (continuous batching, cp).

One torch thread per test: these small tensors gain nothing from more.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.core.gspmd import GSPMDConfig, ShardingRules, param_pspecs
from repro.launch.mesh import make_hier_mesh, make_host_mesh, make_pipe_mesh
from repro.models import transformer as JT
from repro.models.config import reduced as jreduced
from repro.optim import adamw_init as jinit
from repro.posttrain import GenerationEngine as JaxGenerationEngine
from repro_torch import bridge
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import fsdp
from repro_torch.core.ranks import RankGroup
from repro_torch.core.train_step import Trainer
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as TT
from repro_torch.models.config import reduced
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.posttrain.engine import (ContinuousGenerationEngine,
                                          GenerationEngine)
from torch_train_cases import GRAD_TOL, _get, _steps, global_mean_grad

ARCH = "zamba2-1.2b"
LAYERS = 5
TOL = 1e-5
# comm x schedule x world of the step-0 gradient check
TRAIN_CASES = [("collective", "layer", 2), ("odc", "minibatch", 2),
               ("odc", "layer", 2), ("odc-overlap", "overlap", 2),
               ("collective", "overlap", 2), ("hier", "minibatch", 4),
               ("pipe", "1f1b", 4)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tcfg():
    return reduced(get_config(ARCH), num_layers=LAYERS)


def _close(out, ref, tol=TOL):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    err = np.abs(out - ref)
    assert (err <= tol * (1 + np.abs(ref))).all(), float(err.max())


@pytest.fixture(scope="module")
def model():
    """The 5-layer zamba2's JAX weights, with the mamba scalars and the
    norms moved off their init values so that every term counts, and the
    same weights bridged to the port."""
    cfg = jreduced(jconfigs.get_config(ARCH), num_layers=LAYERS)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def perturb(path, x):
        name = path[-1].key
        if name in ("A_log", "dt_bias", "D", "gate_norm", "norm", "conv_b",
                    "final_norm", "attn_norm", "mlp_norm"):
            return x + jnp.asarray(rng.normal(size=x.shape).astype(
                np.float32) * 0.3)
        return x

    params = jax.tree_util.tree_map_with_path(perturb, params)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu")
    return cfg, params, tparams


def _prompts(n, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(1, vocab, size=(n, s)) \
        .astype(np.int32)


# ===========================================================================
# parameters and their layout
# ===========================================================================
def test_param_shapes_match_init_params(model):
    _, params, _ = model
    cfg = _tcfg()
    shapes = TT.param_shapes(cfg)
    drawn = TT.init_params(cfg, torch.Generator().manual_seed(0))
    assert set(shapes) == set(params) == {"embed", "final_norm", "mamba",
                                          "mamba_tail", "shared_attn"}
    for path in fsdp.tree_paths(shapes):
        ref = params
        for k in path:
            ref = ref[k]
        assert fsdp.get(shapes, path).shape == fsdp.get(drawn, path).shape \
            == ref.shape, path
    assert fsdp.tree_paths(shapes) == fsdp.tree_paths(drawn)
    assert fsdp.get(shapes, ("mamba", "norm")).shape == (2, 2, 128)
    assert fsdp.get(shapes, ("mamba_tail", "norm")).shape == (1, 128)
    # no tail at a multiple of the period
    assert "mamba_tail" not in TT.param_shapes(get_reduced(ARCH))


def _layouts():
    """(mesh, rules, ranks, intra) of each layout the port runs."""
    return [(make_host_mesh(data=2), ShardingRules(), 2, None),
            (make_host_mesh(data=4), ShardingRules(), 4, None),
            (make_hier_mesh(nodes=2, device=2),
             ShardingRules(data=("node", "device")), 4, 2),
            (make_pipe_mesh(stages=2, data=2),
             ShardingRules(data=("pipe", "data")), 4, 2)]


def _pspec_dims(jcfg, shapes, layout):
    """{key path: (data dim or None, whether over the inner axis only)}
    of ``param_pspecs`` on a layout."""
    mesh, rules, _, intra = _layouts()[layout]
    specs = param_pspecs(jcfg, shapes, rules, mesh)
    data = rules.data
    inner = data[-1] if isinstance(data, tuple) else data
    out = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda s: isinstance(s, P)):
        at = [i for i, e in enumerate(spec) if e in (data, inner)]
        out[tuple(k.key for k in path)] = (
            at[0] if at else None,
            bool(at) and intra is not None and spec[at[0]] == inner)
    return out


@pytest.mark.parametrize("layout", range(4))
def test_leaves_follow_leaf_pspec(layout):
    """Every leaf of the three groups: ``mamba`` two dims later than its
    logical dim, ``mamba_tail`` one, ``shared_attn`` none; the 1-D leaves
    over the innermost data axis alone under two tiers (``IntraDim``)."""
    _, _, n, intra = _layouts()[layout]
    jcfg = jreduced(jconfigs.get_config(ARCH), num_layers=LAYERS)
    shapes = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    dims = fsdp.leaf_dims(TT.param_shapes(_tcfg()), n, intra)
    want = _pspec_dims(jcfg, shapes, layout)
    assert set(want) == set(fsdp.tree_paths(dims))
    for keys, (at, inner_only) in want.items():
        d = fsdp.get(dims, keys)
        if at is None:
            assert d is None, keys
        elif inner_only:
            assert isinstance(d, fsdp.IntraDim), keys
            assert (int(d), d.intra) == (at, intra), keys
        else:
            assert type(d) is int and d == at, keys
    assert fsdp.get(dims, ("mamba", "mamba", "in_proj")) == 2
    assert fsdp.get(dims, ("mamba_tail", "mamba", "out_proj")) == 2
    assert fsdp.get(dims, ("shared_attn", "attn", "wo")) == 1


def _single_key_dim(path, shape, n, intra):
    """The rule before stack depths per group: one stacked dim under
    ``layers``, none elsewhere."""
    name = path[-1]
    stacked = 1 if path[0] == "layers" else 0
    if name in ("lm_head", "wq", "wk", "wv", "w_gate", "w_up", "in_proj"):
        d = 0
    elif name in ("embed", "wo", "w_down", "out_proj", "conv_w"):
        d = 1
    else:
        d = len(shape) - stacked - 1
        if intra is not None and intra != n:
            dim = stacked + d
            if intra == 1 or shape[dim] % intra or shape[dim] < intra:
                return None
            return fsdp.IntraDim(dim, intra)
    dim = stacked + d
    return None if shape[dim] % n or shape[dim] < n else dim


@pytest.mark.parametrize("arch", ["qwen-1.5b", "mamba2-2.7b"])
@pytest.mark.parametrize("full", [False, True])
def test_stack_rule_keeps_dense_and_ssm_dims(arch, full):
    cfg = get_config(arch) if full else get_reduced(arch)
    shapes = TT.param_shapes(cfg)
    for n, intra in ((2, None), (4, None), (3, None), (4, 2), (2, 1)):
        dims = fsdp.leaf_dims(shapes, n, intra)
        for path in fsdp.tree_paths(shapes):
            want = _single_key_dim(path, tuple(fsdp.get(shapes, path).shape),
                                   n, intra)
            got = fsdp.get(dims, path)
            assert got == want and type(got) is type(want), (path, n, intra)
        lay = fsdp.layer_dims(dims)
        for path in fsdp.tree_paths(lay):
            assert fsdp.get(lay, path) == fsdp.shifted(
                fsdp.get(dims, ("layers",) + path), -1), path


# ===========================================================================
# the model
# ===========================================================================
def test_prefill_and_decode_match_jax(model):
    cfg, params, tparams = model
    tcfg = _tcfg()
    Bsz, S = 3, 45  # 45 tokens pad the chunk of 32 with dt = 0 steps
    prompts = _prompts(Bsz, S + 2, cfg.vocab_size, seed=1)
    cache = TT.init_cache(tcfg, Bsz, S + 2, device="cpu")
    jcache = JT.init_cache(cfg, Bsz, S + 2)
    shape = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)
    assert shape(cache) == shape(jcache)
    for i, sl in enumerate((slice(0, S), slice(S, S + 1),
                            slice(S + 1, S + 2))):
        tok = prompts[:, sl]
        pos = np.broadcast_to(np.arange(sl.start, sl.stop), tok.shape)
        logits, _, new = TT.apply(
            tcfg, tparams, {"tokens": torch.from_numpy(tok).long(),
                            "positions": torch.from_numpy(pos.copy())},
            caches=cache, cache_index=sl.start, last_only=i == 0)
        ref, _, jcache = JT.apply(
            cfg, params, {"tokens": jnp.asarray(tok),
                          "positions": jnp.asarray(pos)},
            caches=jcache, cache_index=sl.start, last_only=i == 0)
        _close(logits, ref)
        for group in ("mamba", "attn", "tail"):
            for k in jcache[group]:
                out, want = np.asarray(new[group][k]), \
                    np.asarray(jcache[group][k])
                assert out.shape == want.shape
                err = float(np.abs(out - want).max())
                assert err <= TOL * (1 + np.abs(want).max()), (group, k, err)
        cache = new


# layers -> the gradient tolerance of test_loss_and_gradients_match; at 5
# layers each package's own f32 gradient is up to F32_FLOOR off the exact
# one (test_float32_gradients_match_float64), so the two may differ by more
# than 1e-5 (the worst leaf reads 1.25e-5)
LOSS_GRAD_TOL = {2: 1e-5, LAYERS: 2e-5}
# each leaf's f32 gradient against the port's float64 gradient on the same
# weights, as a share of the leaf's largest |g|: the worst leaves read
# 1.16e-5 (the port, dt_bias) and 1.14e-5 (JAX, A_log under remat)
F32_FLOOR = 1.5e-5


def _jax_grads(cfg, params, mb, remat, reduction):
    (ref, jm), jg = jax.value_and_grad(
        lambda p: JT.loss(cfg, p, mb, remat=remat, reduction=reduction),
        has_aux=True)(params)
    grads = {tuple(k.key for k in path): np.asarray(g)
             for path, g in jax.tree_util.tree_leaves_with_path(jg)}
    return float(ref), float(jm["tokens"]), grads


def _port_grads(layers, params, tmb, remat, reduction, dtype=torch.float32):
    """(loss, tokens, path -> gradient) of the port's ``TT.loss`` on the JAX
    weights ``params``, carried over and cast to ``dtype``."""
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    leaves = {}
    for path in fsdp.tree_paths(tp):
        leaves[path] = fsdp.get(tp, path).to(dtype).requires_grad_(True)
        fsdp.put(tp, path, leaves[path])
    loss, m = TT.loss(reduced(get_config(ARCH), num_layers=layers), tp, tmb,
                      remat=remat, reduction=reduction)
    loss.backward()
    return loss.item(), float(m["tokens"]), {
        path: x.grad.numpy() for path, x in leaves.items()}


def _microbatch():
    jb, tb, _ = _steps(2, 1)[0]
    return ({k: v[0, 0:1] for k, v in jb.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v[0, 0:1]))
             for k, v in tb.items()})


@pytest.mark.parametrize("layers", sorted(LOSS_GRAD_TOL))
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_loss_and_gradients_match(model, layers, remat, reduction):
    cfg, params, _ = model
    if layers != LAYERS:
        cfg = jreduced(jconfigs.get_config(ARCH), num_layers=layers)
        params = JT.init_params(cfg, jax.random.PRNGKey(0))
    mb, tmb = _microbatch()
    ref, jtok, jg = _jax_grads(cfg, params, mb, remat, reduction)
    ours, tok, tg = _port_grads(layers, params, tmb, remat, reduction)
    assert tok == jtok
    assert abs(ours - ref) <= 1e-6 * abs(ref)
    for keys, g in jg.items():
        err = np.abs(tg[keys] - g).max()
        assert err <= LOSS_GRAD_TOL[layers] * np.abs(g).max(), \
            (keys, float(err))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_float32_gradients_match_float64(model, remat, reduction):
    """The reading under LOSS_GRAD_TOL at 5 layers: the port's forward in
    float64 on the same weights, differentiated, holds both packages' f32
    gradients within F32_FLOOR of each leaf's largest |g|.  The JAX one
    coming as close as the port's own shows that the float64 gradient is
    the reference's function, not only the port's."""
    cfg, params, _ = model
    mb, tmb = _microbatch()
    ref, _, jg = _jax_grads(cfg, params, mb, remat, reduction)
    exact, _, g64 = _port_grads(LAYERS, params, tmb, remat, reduction,
                                torch.float64)
    _, _, g32 = _port_grads(LAYERS, params, tmb, remat, reduction)
    assert abs(exact - ref) <= 1e-6 * abs(exact)
    for keys, want in g64.items():
        for who, got in (("jax", jg[keys]), ("port", g32[keys])):
            err = np.abs(got - want).max()
            assert err <= F32_FLOOR * np.abs(want).max(), \
                (who, keys, float(err))


@pytest.fixture(scope="module")
def step0(model):
    """world -> (the step-0 batch, its counts, and jax.grad of the global
    mean loss), each world computed once."""
    cfg, params, _ = model
    done = {}

    def get(world):
        if world not in done:
            jb, tb, counts = _steps(world, 1)[0]
            done[world] = (tb, counts) + global_mean_grad(cfg, params, jb,
                                                          world)
        return done[world]

    return get


@pytest.mark.parametrize("comm,schedule,world", TRAIN_CASES)
def test_step0_gradients_match_jax_grad(step0, model, comm, schedule,
                                        world):
    tb, counts, loss, tok, ref = step0(world)
    _, params, _ = model
    tr = Trainer(_tcfg(), RankGroup.make(world, "cpu"), comm=comm,
                 schedule=schedule, opt_cfg=AdamWConfig(lr=1e-3))
    shards, _ = bridge.train_state_from_numpy(
        jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, jinit(params)), tr)
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


def test_shared_block_is_scattered_once_per_microbatch(model):
    """Under 'layer' the shared block is gathered with the top-level
    leaves, once per forward, and its gradient (the sum over its n_super
    invocations) scattered once per microbatch: the scatter count is the
    top-level leaves' and the mamba blocks', whatever n_super is."""
    _, params, _ = model
    _, tb, counts = _steps(2, 1)[0]
    tr = Trainer(_tcfg(), RankGroup.make(2, "cpu"), comm="collective",
                 schedule="layer")
    shards, _ = bridge.train_state_from_numpy(
        jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, jinit(params)), tr)
    calls = []
    scatter = tr.backend.scatter_dim
    tr.backend.scatter_dim = lambda ys, d, o=None: (
        calls.append(len(ys)), scatter(ys, d, o))[1]
    try:
        tr.grads(shards, tb, counts)
    finally:
        del tr.backend.scatter_dim
    dims = tr.dims
    top = len(fsdp.tree_paths(fsdp.top_dims(dims)))
    block = len(fsdp.tree_paths(fsdp.layer_dims(dims, "mamba")))
    M = tb["tokens"].shape[0]
    assert len(calls) == M * (top + LAYERS * block)


# ===========================================================================
# serving
# ===========================================================================
def test_wave_generate_matches_jax(model):
    cfg, params, tparams = model
    Bsz, S, G = 4, 40, 8
    prompts = _prompts(Bsz, S, cfg.vocab_size, seed=2)
    jeng = JaxGenerationEngine(cfg, make_host_mesh(),
                               GSPMDConfig(rules=ShardingRules()))
    jgen = np.asarray(jeng.generate(params, prompts, G).generated)

    engine = GenerationEngine(_tcfg(), device="cpu")
    logits, cache = engine.prefill(tparams, engine.prompt_batch(prompts),
                                   engine.init_cache(Bsz, S + G))
    assert cache["tail"]["ssm"].shape[0] == 1
    steps = [logits[:, -1]]
    tok = logits[:, -1].argmax(-1)[:, None]
    for i in range(G - 1):
        logits, cache = engine.decode(tparams, cache, tok, S + i)
        steps.append(logits[:, -1])
        tok = logits[:, -1].argmax(-1)[:, None]
    top2 = torch.stack(steps, 1).topk(2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    assert margin > 2 * TOL * (1 + float(top2.abs().max())), margin
    np.testing.assert_array_equal(torch.stack(steps, 1).argmax(-1).numpy(),
                                  jgen)
    np.testing.assert_array_equal(
        engine.generate(tparams, prompts, G).generated, jgen)


def test_serve_driver_on_cpu():
    summary = serve.run(serve.parse_args(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
         "--prompt-len", "40", "--gen", "4", "--quiet"]))
    assert summary["num_layers"] == 2
    assert (summary["prefill_calls"], summary["decode_steps"]) == (1, 3)
    assert summary["generated"].shape == (2, 4) and summary["ids_in_vocab"]


# ===========================================================================
# refusals
# ===========================================================================
def test_continuous_batching_refuses_the_family():
    with pytest.raises(NotImplementedError, match="GenerationEngine"):
        ContinuousGenerationEngine(_tcfg(), slots=2, max_len=16,
                                   device="cpu")
    with pytest.raises(NotImplementedError, match="GenerationEngine"):
        serve.run(serve.parse_args(["--arch", ARCH, "--reduced", "--device",
                                    "cpu", "--continuous", "--quiet"]))


def test_context_parallelism_refuses_the_family(model):
    _, _, tparams = model
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        train_cli.run(train_cli.parse_args(
            ["--arch", ARCH, "--reduced", "--device", "cpu", "--comm", "cp",
             "--cp", "2", "--data-axis", "1", "--strategy", "lb_token",
             "--steps", "1", "--quiet"]))
    tok = torch.zeros((1, 8), dtype=torch.long)
    batch = {"tokens": tok, "targets": tok}
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        TT.loss_ranks(_tcfg(), [tparams, tparams], [batch, batch], cp=2)
