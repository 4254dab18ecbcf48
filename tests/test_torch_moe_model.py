"""The port's moe family (reduced grok-1-314b: 2 moe layers, 4 experts
top-2, gelu, attention and final soft-capping; reduced
llama4-maverick-400b-a17b: one super-layer of a dense block and a moe
block, 4 experts top-1, swiglu, a shared expert and 8 vision-stub
positions) and vlm family (reduced chameleon-34b: qk-norm) against
``repro.models.transformer``, on the CPU.

Routing is held first, by ``moe.routing_rule``: every moe block's router
inputs in the port's forward are recorded (``chip_smoke._Routing``), and
the JAX ``_router`` on the same inputs and weights must pick the same
experts, except at a near-tie (two of a token's top k+1 probabilities
within ``ROUTING_MARGIN``), whose batch row is then left out of the
comparison of outputs (``chip_smoke._hold_routing``).

* ``transformer.apply`` logits within TOL of 1 + |ref| (llama4 with its
  ``vision_embeds`` overlay), and the aux loss within TOL relative;
  ``param_shapes`` and ``init_params`` against the JAX tree.
* ``transformer.loss`` and its gradient against ``jax.value_and_grad`` of
  the JAX ``T.loss`` on one packed microbatch, 'sum' and 'mean', remat on
  and off: the loss within 1e-6 relative (it carries the aux term), each
  leaf's gradient within GRAD_TOL of the leaf's largest |ref|, as
  ``tests/test_torch_train_grads.py`` holds the dense family's.
* Prefill of S-1 tokens and one decode step against the full forward's
  last logits (``test_archs.py::test_decode_matches_full_forward``), with
  the caches' shapes, KV and router tallies against the JAX ones.
* The wave engine's greedy tokens against the JAX ``GenerationEngine``'s
  (llama4, its prompt batch carrying ``vision_embeds``); the serve driver
  end to end; continuous batching refusing both families.

One torch thread per test.
"""
import importlib.util
import os
from pathlib import Path

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.gspmd import GSPMDConfig, ShardingRules
from repro.launch.mesh import make_host_mesh
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro.posttrain import GenerationEngine as JaxGenerationEngine
from repro_torch import bridge
from repro_torch.configs import get_reduced
from repro_torch.core import fsdp
from repro_torch.launch import serve
from repro_torch.models import transformer as TT
from repro_torch.posttrain.engine import (ContinuousGenerationEngine,
                                          GenerationEngine)
from torch_train_cases import GRAD_TOL, _steps

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TOL = 1e-5
ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b", "chameleon-34b")


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = jconfigs.get_reduced(request.param)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    return request.param, cfg, params, bridge.params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu")


def _close(out, ref, tol=TOL, rows=None):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    if rows is not None:
        out, ref = out[rows], ref[rows]
    err = np.abs(out - ref)
    assert (err <= tol * (1 + np.abs(ref))).all(), float(err.max())


def _rows_ok(rec, cfg, params, B):
    """Batch rows with no near-tie in any block that ``rec`` (a
    ``chip_smoke._Routing`` with inputs) recorded: the JAX router on each
    call's tokens and weights against the port's choice, held by
    ``chip_smoke._hold_routing``, which fails on a fault."""
    if not cfg.num_experts:
        assert not rec.calls
        return np.ones(B, bool)
    n_super = cfg.num_layers // cfg.moe_period
    assert len(rec.calls) % n_super == 0 and rec.calls
    routers = np.asarray(params["layers"]["moe"]["moe"]["router"])
    ref = []
    for (toks, w), (_, probs) in zip(rec.inputs, rec.calls):
        # the weights the port routed with are one layer's of the JAX
        # tree (a recompute under remat runs the layers backwards)
        assert any((w.numpy() == r).all() for r in routers)
        _, jtop, _ = jmoe._router(cfg, {"router": jnp.asarray(w.numpy())},
                                  jnp.asarray(toks.numpy()))
        ref.append((torch.tensor(np.asarray(jtop)).long(), probs))
    return chip_smoke._hold_routing(cfg.name, ref, rec.calls, B).numpy()


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32).copy()
    jb = {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos)}
    tb = {"tokens": torch.from_numpy(tok).long(),
          "positions": torch.from_numpy(pos)}
    if cfg.frontend == "vision" and cfg.frontend_tokens:
        ve = rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)).astype(
            np.float32)
        jb["vision_embeds"] = jnp.asarray(ve)
        tb["vision_embeds"] = torch.from_numpy(ve)
    return jb, tb


def test_param_tree_matches_jax(model):
    arch, cfg, params, _ = model
    tcfg = get_reduced(arch)
    shapes = TT.param_shapes(tcfg)
    drawn = TT.init_params(tcfg, torch.Generator().manual_seed(0))
    ref = jax.tree.map(np.asarray, params)
    assert fsdp.tree_paths(shapes) == fsdp.tree_paths(drawn) \
        == fsdp.tree_paths(ref)
    for path in fsdp.tree_paths(shapes):
        assert fsdp.get(shapes, path).shape == fsdp.get(drawn, path).shape \
            == fsdp.get(ref, path).shape, path


def test_apply_logits_match_jax(model):
    arch, cfg, params, tparams = model
    B, S = 3, 80
    jb, tb = _batch(cfg, B, S, seed=1)
    ref, raux, _ = JT.apply(cfg, params, jb)
    with chip_smoke._Routing(inputs=True) as routing:
        out, aux, _ = TT.apply(get_reduced(arch), tparams, tb)
    ok = _rows_ok(routing, cfg, params, B)
    _close(out.detach(), ref, rows=ok)
    if cfg.num_experts:
        assert abs(float(aux) - float(raux)) <= TOL * abs(float(raux))
    else:
        assert aux == 0.0 and float(raux) == 0.0
    if "vision_embeds" in tb:  # the overlay moves the logits
        plain, _, _ = TT.apply(get_reduced(arch), tparams,
                               {k: tb[k] for k in ("tokens", "positions")})
        assert not torch.allclose(plain, out)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_loss_and_gradients_match(model, remat, reduction):
    arch, cfg, params, _ = model
    jb, tb, _ = _steps(2, 1)[0]
    mb = {k: v[0, 0:1] for k, v in jb.items()}
    tmb = {k: torch.from_numpy(np.ascontiguousarray(v[0, 0:1]))
           for k, v in tb.items()}
    if cfg.frontend == "vision" and cfg.frontend_tokens:
        ve = np.random.RandomState(0).randn(
            1, cfg.frontend_tokens, cfg.d_model).astype(np.float32)
        mb["vision_embeds"] = jnp.asarray(ve)
        tmb["vision_embeds"] = torch.from_numpy(ve)
    (ref, jm), jg = jax.value_and_grad(
        lambda p: JT.loss(cfg, p, mb, remat=remat, reduction=reduction),
        has_aux=True)(params)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    for path in fsdp.tree_paths(tp):
        fsdp.get(tp, path).requires_grad_(True)
    with chip_smoke._Routing(inputs=True) as routing:
        ours, tm = TT.loss(get_reduced(arch), tp, tmb, remat=remat,
                           reduction=reduction)
        ours.backward()
    assert _rows_ok(routing, cfg, params, 1).all()
    assert float(tm["tokens"]) == float(jm["tokens"])
    assert abs(float(tm["aux"].detach()) - float(jm["aux"])) \
        <= TOL * abs(float(jm["aux"])) if cfg.num_experts \
        else tm["aux"] == 0.0
    assert abs(ours.item() - float(ref)) <= 1e-6 * abs(float(ref))
    for path, g in jax.tree_util.tree_leaves_with_path(jg):
        keys = tuple(k.key for k in path)
        g = np.asarray(g)
        err = np.abs(fsdp.get(tp, keys).grad.numpy() - g).max()
        assert err <= GRAD_TOL * np.abs(g).max(), (keys, float(err))


def test_decode_matches_full_forward(model):
    """Prefill of S-1 tokens into a cache of S, then the last token: its
    logits against the full forward's (the capacity of the cache's length
    is the full forward's), and every cache against the JAX one."""
    arch, cfg, params, tparams = model
    tcfg = get_reduced(arch)
    B, S = 2, 32
    jb, tb = _batch(cfg, B, S, seed=2)
    for k in ("vision_embeds",):
        jb.pop(k, None)
        tb.pop(k, None)
    cache = TT.init_cache(tcfg, B, S, device="cpu")
    jcache = JT.init_cache(cfg, B, S)
    shape = lambda t: jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                                   t)
    assert shape(jax.tree.map(np.asarray, cache)) == \
        shape(jax.tree.map(np.asarray, jcache))
    pre = {k: v[:, :S - 1] for k, v in tb.items()}
    dec = {k: v[:, S - 1:] for k, v in tb.items()}
    with chip_smoke._Routing(inputs=True) as routing:
        full, _, _ = TT.apply(tcfg, tparams, tb)
        _, _, cache = TT.apply(tcfg, tparams, pre, caches=cache,
                               cache_index=0)
        logits, _, cache = TT.apply(tcfg, tparams, dec, caches=cache,
                                    cache_index=S - 1)
    ok = _rows_ok(routing, cfg, params, B)
    _close(logits[:, 0], full[:, -1], rows=ok)
    for sl, idx in ((slice(0, S - 1), 0), (slice(S - 1, S), S - 1)):
        _, _, jcache = JT.apply(cfg, params, {k: v[:, sl]
                                              for k, v in jb.items()},
                                caches=jcache, cache_index=idx)
    for path, want in jax.tree_util.tree_leaves_with_path(jcache):
        keys = tuple(k.key for k in path)
        got = fsdp.get(cache, keys).numpy()
        if keys[-1] == "router_counts":
            np.testing.assert_array_equal(got, np.asarray(want))
            assert int(got.sum()) == (cfg.num_layers // cfg.moe_period) \
                * B * S * cfg.experts_per_token
        else:
            _close(got, want)


def test_wave_generate_matches_jax():
    arch = "llama4-maverick-400b-a17b"
    cfg = jconfigs.get_reduced(arch)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu")
    Bsz, S, G = 4, 24, 6
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, cfg.vocab_size, size=(Bsz, S)).astype(np.int32)
    ve = rng.normal(size=(Bsz, cfg.frontend_tokens, cfg.d_model)).astype(
        np.float32)
    jeng = JaxGenerationEngine(cfg, make_host_mesh(),
                               GSPMDConfig(rules=ShardingRules()))
    jgen = np.asarray(jeng.generate(
        params, prompts, G,
        batch_extras={"vision_embeds": jnp.asarray(ve)}).generated)
    engine = GenerationEngine(get_reduced(arch), device="cpu")
    extras = {"vision_embeds": torch.from_numpy(ve)}
    batch = dict(engine.prompt_batch(prompts), **extras)
    logits, cache = engine.prefill(tparams, batch,
                                   engine.init_cache(Bsz, S + G))
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
        engine.generate(tparams, prompts, G, batch_extras=extras).generated,
        jgen)
    assert int(cache["moe"]["router_counts"].sum()) == Bsz * (S + G - 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_driver_on_cpu(arch):
    summary = serve.run(serve.parse_args(
        ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
         "--prompt-len", "16", "--gen", "4", "--quiet"]))
    assert (summary["prefill_calls"], summary["decode_steps"]) == (1, 3)
    assert summary["generated"].shape == (2, 4) and summary["ids_in_vocab"]


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batching_refuses_the_family(arch):
    with pytest.raises(NotImplementedError, match="GenerationEngine"):
        ContinuousGenerationEngine(get_reduced(arch), slots=2, max_len=16,
                                   device="cpu")
