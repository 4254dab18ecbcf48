"""The port's ssm family (reduced mamba2-2.7b: 2 layers, d_model 128, 8
heads of 32, state 16, chunk 32) against the JAX package, on the CPU.

* ``transformer.param_shapes`` against ``init_params``; the sharded dim
  of every mamba leaf against ``gspmd.param_pspecs``, flat (2 and 4
  ranks) and two-tier (2 x 2 as hier and as pipe).
* ``transformer.apply``: prefill into a fresh cache and two decode steps,
  the logits and the stacked caches against the JAX ``T.apply``: 1e-5
  relative.  The caches passed in are not written, and a JAX cache
  crosses over through ``bridge.params_from_numpy`` as it is.
* ``transformer.loss`` and its gradient on one packed microbatch (the
  packing's segments and positions reach the model and, as in the
  reference, are not read): the loss within 1e-6 relative, each leaf's
  gradient within 1e-5 of the leaf's largest |ref| (f32 sums over the
  tokens in another order).
* The wave engine's greedy tokens against the JAX ``GenerationEngine``'s,
  with every step's top-2 logit margin above the logits' tolerance, and
  the serve driver end to end.
* What the port refuses for the family: continuous batching (as the JAX
  engine does) and context parallelism; and the vlm and moe families.

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
from repro.posttrain import GenerationEngine as JaxGenerationEngine
from repro_torch import bridge
from repro_torch.configs import get_reduced
from repro_torch.core import fsdp
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as TT
from repro_torch.posttrain.engine import (ContinuousGenerationEngine,
                                          GenerationEngine)
from torch_train_cases import _steps

ARCH = "mamba2-2.7b"
TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(out, ref, tol=TOL):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    err = np.abs(out - ref)
    assert (err <= tol * (1 + np.abs(ref))).all(), float(err.max())


@pytest.fixture(scope="module")
def model():
    """The reduced mamba2's JAX weights, with A_log, dt_bias, D and the
    norms moved off their init values so that every term counts, and the
    same weights bridged to the port."""
    cfg = jconfigs.get_reduced(ARCH)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def perturb(path, x):
        name = path[-1].key
        if name in ("A_log", "dt_bias", "D", "gate_norm", "norm", "conv_b",
                    "final_norm"):
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
    cfg = get_reduced(ARCH)
    shapes = TT.param_shapes(cfg)
    drawn = TT.init_params(cfg, torch.Generator().manual_seed(0))
    for path in fsdp.tree_paths(shapes):
        ref = params
        for k in path:
            ref = ref[k]
        assert fsdp.get(shapes, path).shape == fsdp.get(drawn, path).shape \
            == ref.shape, path
    assert fsdp.tree_paths(shapes) == fsdp.tree_paths(drawn)


def _layouts():
    """(mesh, rules, ranks, intra) of each layout the port runs."""
    return [(make_host_mesh(data=2), ShardingRules(), 2, None),
            (make_host_mesh(data=4), ShardingRules(), 4, None),
            (make_hier_mesh(nodes=2, device=2),
             ShardingRules(data=("node", "device")), 4, 2),
            (make_pipe_mesh(stages=2, data=2),
             ShardingRules(data=("pipe", "data")), 4, 2)]


@pytest.mark.parametrize("layout", range(4))
def test_mamba_leaves_follow_leaf_pspec(layout):
    """in_proj on dim 0, out_proj and conv_w on dim 1, the 1-D leaves
    (norm, conv_b, dt_bias, A_log, D, gate_norm) on their last dim, over
    the innermost data axis alone under two tiers (``IntraDim``)."""
    mesh, rules, n, intra = _layouts()[layout]
    cfg = jconfigs.get_reduced(ARCH)
    shapes = jax.eval_shape(lambda k: JT.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    specs = param_pspecs(cfg, shapes, rules, mesh)
    dims = fsdp.leaf_dims(TT.param_shapes(get_reduced(ARCH)), n, intra)
    data = rules.data
    inner = data[-1] if isinstance(data, tuple) else data
    seen = set()
    for path, spec in jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda s: isinstance(s, P)):
        keys = tuple(k.key for k in path)
        d = fsdp.get(dims, keys)
        at = [i for i, e in enumerate(spec) if e in (data, inner)]
        if not at:
            assert d is None, keys
        elif intra is not None and spec[at[0]] == inner:
            assert isinstance(d, fsdp.IntraDim), keys
            assert (int(d), d.intra) == (at[0], intra), keys
        else:
            assert type(d) is int and d == at[0], keys
        seen.add(keys[-1])
    assert {"in_proj", "out_proj", "conv_w", "conv_b", "dt_bias", "A_log",
            "D", "gate_norm", "norm"} <= seen


# ===========================================================================
# the model
# ===========================================================================
def test_prefill_and_decode_match_jax(model):
    cfg, params, tparams = model
    B, S = 3, 45  # 45 tokens pad the chunk of 32 with dt = 0 steps
    prompts = _prompts(B, S + 2, cfg.vocab_size, seed=1)
    cache = TT.init_cache(get_reduced(ARCH), B, S + 2, device="cpu")
    jcache = JT.init_cache(cfg, B, S + 2)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    for i, sl in enumerate((slice(0, S), slice(S, S + 1),
                            slice(S + 1, S + 2))):
        tok = prompts[:, sl]
        pos = np.broadcast_to(np.arange(sl.start, sl.stop), tok.shape)
        logits, _, new = TT.apply(
            get_reduced(ARCH), tparams,
            {"tokens": torch.from_numpy(tok).long(),
             "positions": torch.from_numpy(pos.copy())},
            caches=cache, cache_index=sl.start, last_only=i == 0)
        ref, _, jcache = JT.apply(
            cfg, params, {"tokens": jnp.asarray(tok),
                          "positions": jnp.asarray(pos)},
            caches=jcache, cache_index=sl.start, last_only=i == 0)
        _close(logits, ref)
        for k in ("conv", "ssm"):
            _close(new[k], jcache[k])
        if i == 0:
            assert not any(v.any() for v in cache.values())
        cache = new
    # the JAX cache bridged over drives the port's next step the same way
    bridged = bridge.params_from_numpy(jax.tree.map(np.asarray, jcache),
                                       "cpu")
    step = {"tokens": torch.from_numpy(prompts[:, -1:]).long()}
    for k in ("conv", "ssm"):
        assert bridged[k].dtype == cache[k].dtype
    _close(TT.apply(get_reduced(ARCH), tparams, step, caches=bridged)[0],
           TT.apply(get_reduced(ARCH), tparams, step, caches=cache)[0])


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_loss_and_gradients_match(model, remat, reduction):
    cfg, params, _ = model
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
    ours, tm = TT.loss(get_reduced(ARCH), tp, tmb, remat=remat,
                       reduction=reduction)
    ours.backward()
    assert float(tm["tokens"]) == float(jm["tokens"])
    assert abs(ours.item() - float(ref)) <= 1e-6 * abs(float(ref))
    for path, g in jax.tree_util.tree_leaves_with_path(jg):
        keys = tuple(k.key for k in path)
        g = np.asarray(g)
        err = np.abs(fsdp.get(tp, keys).grad.numpy() - g).max()
        assert err <= TOL * np.abs(g).max(), (keys, float(err))


# ===========================================================================
# serving
# ===========================================================================
def test_wave_generate_matches_jax(model):
    cfg, params, tparams = model
    B, S, G = 4, 40, 8
    prompts = _prompts(B, S, cfg.vocab_size, seed=2)
    jeng = JaxGenerationEngine(cfg, make_host_mesh(),
                               GSPMDConfig(rules=ShardingRules()))
    jgen = np.asarray(jeng.generate(params, prompts, G).generated)

    engine = GenerationEngine(get_reduced(ARCH), device="cpu")
    logits, cache = engine.prefill(tparams, engine.prompt_batch(prompts),
                                   engine.init_cache(B, S + G))
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_driver_on_cpu(dtype):
    """End to end; bfloat16 weights against the f32 activations the
    mixers promote to, as the reference's jnp products do."""
    summary = serve.run(serve.parse_args(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
         "--prompt-len", "40", "--gen", "4", "--dtype", dtype, "--quiet"]))
    assert summary["num_layers"] == 2
    assert (summary["prefill_calls"], summary["decode_steps"]) == (1, 3)
    assert summary["generated"].shape == (2, 4) and summary["ids_in_vocab"]


# ===========================================================================
# refusals
# ===========================================================================
def test_continuous_batching_refuses_the_family():
    cfg = get_reduced(ARCH)
    with pytest.raises(NotImplementedError, match="GenerationEngine"):
        ContinuousGenerationEngine(cfg, slots=2, max_len=16, device="cpu")
    with pytest.raises(NotImplementedError, match="GenerationEngine"):
        serve.run(serve.parse_args(["--arch", ARCH, "--reduced", "--device",
                                    "cpu", "--continuous", "--quiet"]))


def test_context_parallelism_refuses_the_family(model):
    _, _, tparams = model
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_cli.run(train_cli.parse_args(
            ["--arch", ARCH, "--reduced", "--device", "cpu", "--comm", "cp",
             "--cp", "2", "--data-axis", "1", "--strategy", "lb_token",
             "--steps", "1", "--quiet"]))
    tok = torch.zeros((1, 8), dtype=torch.long)
    batch = {"tokens": tok, "targets": tok}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TT.loss_ranks(get_reduced(ARCH), [tparams, tparams], [batch, batch],
                      cp=2)


def test_other_families_stay_refused():
    """The refusals the audio family keeps beside the ssm family's: the
    cp and two-tier train paths and continuous batching, each naming the
    ROADMAP."""
    from repro_torch.core.ranks import RankGroup
    from repro_torch.core.train_step import Trainer

    for arch in ("seamless-m4t-medium",):  # audio: the last family ported
        cfg = get_reduced(arch)
        params = TT.init_params(cfg, torch.Generator())
        tok = torch.zeros((1, 8), dtype=torch.long)
        batch = {"tokens": tok, "targets": tok}
        for call in (
                lambda: TT.require_cp(cfg),
                lambda: TT.loss_ranks(cfg, [params, params], [batch, batch],
                                      cp=2),
                lambda: Trainer(cfg, RankGroup.make(4, "cpu"), comm="hier"),
                lambda: Trainer(cfg, RankGroup.make(4, "cpu"), comm="pipe"),
                lambda: Trainer(cfg, RankGroup.make(4, "cpu"),
                                comm="pipe-int8"),
                lambda: ContinuousGenerationEngine(cfg, slots=2, max_len=16,
                                                   device="cpu")):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                call()
