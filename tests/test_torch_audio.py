"""The port's audio family (reduced seamless-m4t-medium: 2 encoder and 2
decoder layers, 4 heads over 2 kv heads of 32, gelu, a tied embedding)
against ``repro.models.transformer`` and ``repro.models.layers``, on the
CPU.

* ``layers.attn_apply`` with ``cross_kv`` (S != T, packed q positions,
  with and without the q norm) and with ``causal=False`` (the encoder's
  self-attention, with and without segment ids) within TOL of 1 + |ref|.
* ``param_shapes`` and ``init_params`` against the JAX tree.
* ``transformer.apply`` logits of a batch carrying ``encoder_embeds``
  within TOL of 1 + |ref|.
* ``transformer.loss`` and its gradient against ``jax.value_and_grad`` of
  the JAX ``T.loss`` on one packed microbatch with 16 frames, 'sum' and
  'mean', remat on and off: the loss within 1e-6 relative, each leaf's
  gradient within GRAD_TOL of the leaf's largest |ref|, as
  ``tests/test_torch_train_grads.py`` holds the dense family's.
* Prefill of S-1 tokens and one decode step against the full forward's
  last logits within ``tests/test_archs.py``'s 2e-3, the decode step with
  the frames again (re-encoded) and without them (the cached encoder
  output), and the caches against the JAX ones.
* The wave engine's greedy tokens against the JAX ``GenerationEngine``'s
  (``enc_len`` = the prompt length); the serve driver end to end;
  continuous batching refusing the family.

One torch thread per test.
"""
import dataclasses
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.gspmd import GSPMDConfig, ShardingRules
from repro.launch.mesh import make_host_mesh
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.posttrain import GenerationEngine as JaxGenerationEngine
from repro_torch import bridge
from repro_torch.configs import get_reduced
from repro_torch.core import fsdp
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.posttrain.engine import (ContinuousGenerationEngine,
                                          GenerationEngine)
from torch_train_cases import GRAD_TOL, _steps, one_torch_thread  # noqa

ARCH = "seamless-m4t-medium"
TOL = 1e-5
#: frames a microbatch row carries in training (the train driver's stub)
FRAMES = 16


@pytest.fixture(scope="module")
def model():
    cfg = jconfigs.get_reduced(ARCH)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, bridge.params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu")


def _close(out, ref, tol=TOL):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    err = np.abs(out - ref)
    assert (err <= tol * (1 + np.abs(ref))).all(), float(err.max())


def _batch(cfg, B, S, seed, frames):
    """(JAX batch, port batch): tokens, positions and ``encoder_embeds``
    (B, frames, d)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32).copy()
    enc = rng.normal(size=(B, frames, cfg.d_model)).astype(np.float32)
    jb = {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos),
          "encoder_embeds": jnp.asarray(enc)}
    tb = {"tokens": torch.from_numpy(tok).long(),
          "positions": torch.from_numpy(pos),
          "encoder_embeds": torch.from_numpy(enc)}
    return jb, tb


# ===========================================================================
# attention
# ===========================================================================
@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_matches_jax(qk_norm):
    """q from the decoder's packed positions, k and v of 12 encoder
    frames as given: no rope, no k norm, every frame visible."""
    cfg = dataclasses.replace(jconfigs.get_reduced(ARCH), qk_norm=qk_norm)
    tcfg = dataclasses.replace(get_reduced(ARCH), qk_norm=qk_norm)
    p = JL.attn_params(jax.random.PRNGKey(1), cfg, jnp.float32)
    if qk_norm:  # zeros at init: make the norm do something
        p["q_norm"] = 0.3 * jax.random.normal(jax.random.PRNGKey(2),
                                              p["q_norm"].shape)
    B, S, T = 2, 20, 12
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    kv = [rng.normal(size=(B, T, cfg.num_kv_heads, cfg.resolved_head_dim))
          .astype(np.float32) for _ in range(2)]
    pos = np.concatenate([np.arange(12), np.arange(8)])[None].repeat(B, 0)
    ref, _ = JL.attn_apply(cfg, p, jnp.asarray(x),
                           positions=jnp.asarray(pos),
                           cross_kv=tuple(map(jnp.asarray, kv)))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    out, cache = TL.attn_apply(tcfg, tp, torch.from_numpy(x),
                               positions=torch.from_numpy(pos),
                               cross_kv=tuple(map(torch.from_numpy, kv)))
    assert cache is None
    _close(out, ref)
    with pytest.raises(ValueError, match="no cache"):
        TL.attn_apply(tcfg, tp, torch.from_numpy(x),
                      cross_kv=tuple(map(torch.from_numpy, kv)),
                      cache={"k": torch.zeros(1), "v": torch.zeros(1)})


@pytest.mark.parametrize("segments", [False, True])
def test_bidirectional_self_attention_matches_jax(segments):
    cfg = jconfigs.get_reduced(ARCH)
    p = JL.attn_params(jax.random.PRNGKey(4), cfg, jnp.float32)
    B, S = 2, 24
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    seg = (np.arange(S) >= 10).astype(np.int32)[None].repeat(B, 0)
    kw_j = {"segment_ids": jnp.asarray(seg)} if segments else {}
    kw_t = {"segment_ids": torch.from_numpy(seg)} if segments else {}
    ref, _ = JL.attn_apply(cfg, p, jnp.asarray(x), causal=False, **kw_j)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    out, _ = TL.attn_apply(get_reduced(ARCH), tp, torch.from_numpy(x),
                           causal=False, **kw_t)
    _close(out, ref)
    causal, _ = TL.attn_apply(get_reduced(ARCH), tp, torch.from_numpy(x),
                              **kw_t)
    assert not torch.allclose(causal, out)


# ===========================================================================
# the model
# ===========================================================================
def test_param_tree_matches_jax(model):
    _, params, _ = model
    tcfg = get_reduced(ARCH)
    shapes = TT.param_shapes(tcfg)
    drawn = TT.init_params(tcfg, torch.Generator().manual_seed(0))
    ref = jax.tree.map(np.asarray, params)
    assert fsdp.tree_paths(shapes) == fsdp.tree_paths(drawn) \
        == fsdp.tree_paths(ref)
    for path in fsdp.tree_paths(shapes):
        assert fsdp.get(shapes, path).shape == fsdp.get(drawn, path).shape \
            == fsdp.get(ref, path).shape, path
    assert set(ref["dec_layers"]) >= {"cross", "cross_norm"}


def test_apply_logits_match_jax(model):
    cfg, params, tparams = model
    jb, tb = _batch(cfg, 3, 40, seed=1, frames=24)
    ref, raux, _ = JT.apply(cfg, params, jb)
    out, aux, caches = TT.apply(get_reduced(ARCH), tparams, tb)
    assert caches is None and aux == 0.0 and float(raux) == 0.0
    _close(out.detach(), ref)
    # the frames move the logits: the decoder reads the encoder
    other = dict(tb, encoder_embeds=tb["encoder_embeds"].flip(1))
    moved, _, _ = TT.apply(get_reduced(ARCH), tparams, other)
    assert not torch.allclose(moved, out)
    with pytest.raises(ValueError, match="encoder_embeds"):
        TT.apply(get_reduced(ARCH), tparams,
                 {k: tb[k] for k in ("tokens", "positions")})


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_loss_and_gradients_match(model, remat, reduction):
    cfg, params, _ = model
    jb, tb, _ = _steps(2, 1)[0]
    mb = {k: v[0, 0:1] for k, v in jb.items()}
    tmb = {k: torch.from_numpy(np.ascontiguousarray(v[0, 0:1]))
           for k, v in tb.items()}
    enc = np.random.RandomState(0).randn(1, FRAMES, cfg.d_model).astype(
        np.float32)
    mb["encoder_embeds"] = jnp.asarray(enc)
    tmb["encoder_embeds"] = torch.from_numpy(enc)
    (ref, jm), jg = jax.value_and_grad(
        lambda p: JT.loss(cfg, p, mb, remat=remat, reduction=reduction),
        has_aux=True)(params)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    for path in fsdp.tree_paths(tp):
        fsdp.get(tp, path).requires_grad_(True)
    ours, tm = TT.loss(get_reduced(ARCH), tp, tmb, remat=remat,
                       reduction=reduction)
    ours.backward()
    assert float(tm["tokens"]) == float(jm["tokens"])
    assert tm["aux"] == 0.0
    assert abs(ours.item() - float(ref)) <= 1e-6 * abs(float(ref))
    for path, g in jax.tree_util.tree_leaves_with_path(jg):
        keys = tuple(k.key for k in path)
        g = np.asarray(g)
        assert np.abs(g).max() > 0, keys  # every leaf is on the path
        err = np.abs(fsdp.get(tp, keys).grad.numpy() - g).max()
        assert err <= GRAD_TOL * np.abs(g).max(), (keys, float(err))


@pytest.mark.parametrize("frames_at_decode", [True, False])
def test_decode_matches_full_forward(model, frames_at_decode):
    """Prefill of S-1 tokens (with the frames) into a cache of S, then the
    last token, with the frames again or from the cached encoder output
    (``enc_len`` > 0): its logits against the full forward's, and the
    caches against the JAX ones."""
    cfg, params, tparams = model
    tcfg = get_reduced(ARCH)
    B, S, F = 2, 32, FRAMES
    jb, tb = _batch(cfg, B, S, seed=2, frames=F)
    enc_len = 0 if frames_at_decode else F
    cache = TT.init_cache(tcfg, B, S, device="cpu", enc_len=enc_len)
    jcache = JT.init_cache(cfg, B, S, enc_len=enc_len)
    shape = lambda t: jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                                   t)
    assert shape(jax.tree.map(np.asarray, cache)) == \
        shape(jax.tree.map(np.asarray, jcache))
    pre = {k: v[:, :S - 1] for k, v in tb.items() if k != "encoder_embeds"}
    dec = {k: v[:, S - 1:] for k, v in tb.items() if k != "encoder_embeds"}
    pre["encoder_embeds"] = tb["encoder_embeds"]
    if frames_at_decode:
        dec["encoder_embeds"] = tb["encoder_embeds"]
    full, _, _ = TT.apply(tcfg, tparams, tb)
    _, _, cache = TT.apply(tcfg, tparams, pre, caches=cache, cache_index=0)
    logits, _, cache = TT.apply(tcfg, tparams, dec, caches=cache,
                                cache_index=S - 1)
    err = float((logits[:, 0] - full[:, -1]).abs().max())
    assert err < 2e-3, err
    _close(logits[:, 0], full[:, -1])
    jpre = {k: v[:, :S - 1] for k, v in jb.items() if k != "encoder_embeds"}
    jdec = {k: v[:, S - 1:] for k, v in jb.items() if k != "encoder_embeds"}
    jpre["encoder_embeds"] = jb["encoder_embeds"]
    if frames_at_decode:
        jdec["encoder_embeds"] = jb["encoder_embeds"]
    for batch, idx in ((jpre, 0), (jdec, S - 1)):
        _, _, jcache = JT.apply(cfg, params, batch, caches=jcache,
                                cache_index=idx)
    for path, want in jax.tree_util.tree_leaves_with_path(jcache):
        keys = tuple(k.key for k in path)
        _close(fsdp.get(cache, keys).numpy(), want)


def test_wave_generate_matches_jax(model):
    cfg, params, tparams = model
    Bsz, S, G = 4, 24, 6
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, cfg.vocab_size, size=(Bsz, S)).astype(np.int32)
    enc = rng.normal(size=(Bsz, S, cfg.d_model)).astype(np.float32)
    jeng = JaxGenerationEngine(cfg, make_host_mesh(),
                               GSPMDConfig(rules=ShardingRules()))
    jgen = np.asarray(jeng.generate(
        params, prompts, G,
        batch_extras={"encoder_embeds": jnp.asarray(enc)}).generated)
    engine = GenerationEngine(get_reduced(ARCH), device="cpu")
    extras = {"encoder_embeds": torch.from_numpy(enc)}
    batch = dict(engine.prompt_batch(prompts), **extras)
    logits, cache = engine.prefill(tparams, batch,
                                   engine.init_cache(Bsz, S + G, enc_len=S))
    assert cache["enc_out"].shape == (Bsz, S, cfg.d_model)
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


def test_serve_driver_on_cpu():
    summary = serve.run(serve.parse_args(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
         "--prompt-len", "16", "--gen", "4", "--quiet"]))
    assert (summary["prefill_calls"], summary["decode_steps"]) == (1, 3)
    assert summary["generated"].shape == (2, 4) and summary["ids_in_vocab"]
    args = serve.parse_args(["--arch", ARCH, "--reduced", "--device", "cpu"])
    extras = serve.stub_extras(get_reduced(ARCH), args, 2, 16)
    assert extras["encoder_embeds"].shape == (2, 16, 128)


def test_continuous_batching_refuses_the_family():
    with pytest.raises(NotImplementedError, match="GenerationEngine"):
        ContinuousGenerationEngine(get_reduced(ARCH), slots=2, max_len=16,
                                   device="cpu")
