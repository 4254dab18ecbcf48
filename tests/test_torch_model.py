"""The port's dense model against the JAX package, on the CPU.

Layer by layer (``rms_norm``, ``apply_rope``, ``mlp_apply``, ``attn_apply``
with no cache, a scalar cache index and a per-row cache index) and whole
``transformer.apply`` logits, for reduced qwen-1.5b and reduced gemma2-9b
(sliding window on alternate layers, attention and final soft-capping,
GeGLU), gemma3-27b at 6 layers (five ``local`` with window 64, then one
``global``: its 5:1 pattern whole, and 80 tokens so that the window cuts),
phi3-medium-14b, minitron-8b and chameleon-34b (the vlm family: qk-norm),
plus one case at qwen-1.5b's full widths with 2 layers and the
vocabulary cut to 4096.  The JAX weights cross over through
``repro_torch.bridge``; inputs are numpy arrays from a seed.  The JAX side
runs its default attention (the jnp ``blockwise_attention``), the port's
its wrapper's plain version.

Tolerance, float32: |diff| <= TOL * (1 + |ref|) with TOL = 1e-5 at reduced
widths and 5e-5 at full width, where the 1536- and 8960-term contractions
are summed in a different order by XLA and by PyTorch.
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
from repro.models import layers as jl
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tl
from repro_torch.models import transformer as TT
from torch_train_cases import reduced_case

TOL = 1e-5
TOL_FULL = 5e-5
ARCHS = ("qwen-1.5b", "gemma2-9b", "gemma3-27b", "phi3-medium-14b",
         "minitron-8b", "chameleon-34b")


def _close(out, ref, tol=TOL):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    err = np.abs(out - ref)
    assert (err <= tol * (1 + np.abs(ref))).all(), float(err.max())


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = reduced_case(request.param)[0]
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu")
    return cfg, params, tparams


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


def test_configs_are_copies():
    """The port's registry resolves every --arch name to the same config
    as the JAX package's, full and reduced."""
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    names = list(jconfigs._ALIASES) + list(jconfigs.ARCH_IDS)
    for name in names:
        assert tconfigs.canonical(name) == jconfigs.canonical(name)
        for get in ("get_config", "get_reduced"):
            ours = getattr(tconfigs, get)(name)
            ref = getattr(jconfigs, get)(name)
            assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
            assert ours.num_params() == ref.num_params()


def test_non_dense_family_raises():
    """What the audio family still refuses: context parallelism, the
    two-tier backends (ROADMAP.md queue 1 item 14) and continuous
    batching (item 2), each naming the ROADMAP."""
    from repro_torch.core import backend
    from repro_torch.posttrain.engine import ContinuousGenerationEngine

    cfg = tconfigs.get_reduced("seamless-m4t-medium")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    tok = torch.zeros((1, 8), dtype=torch.long)
    batch = {"tokens": tok, "targets": tok}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TT.require_cp(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TT.loss_ranks(cfg, [params, params], [batch, batch], cp=2)
    for comm in ("hier", "pipe", "pipe-int8"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            backend.resolve(comm, "minibatch", audio=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContinuousGenerationEngine(cfg, slots=2, max_len=16, device="cpu")


# ===========================================================================
# layers
# ===========================================================================
def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    s = rng.normal(size=(64,)).astype(np.float32) * 0.1
    _close(tl.rms_norm(torch.tensor(x), torch.tensor(s), 1e-6),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6))


@pytest.mark.parametrize("hd", [32, 128])
def test_apply_rope(hd):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(2, 7)).astype(np.int32)
    _close(tl.apply_rope(torch.tensor(x), torch.tensor(pos), 10_000.0),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))


@pytest.mark.parametrize("name", ["swiglu", "geglu", "gelu"])
def test_activation_fn(name):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    _close(tl.activation_fn(name)(torch.tensor(x)),
           jl.activation_fn(name)(jnp.asarray(x)))


def test_softcap():
    x = np.linspace(-200, 200, 41, dtype=np.float32)
    _close(tl.softcap(torch.tensor(x), 30.0), jl.softcap(jnp.asarray(x), 30.0))


def test_mlp_apply(model):
    cfg, params, tparams = model
    x = np.random.default_rng(2).normal(size=(2, 6, cfg.d_model))
    x = x.astype(np.float32)
    _close(tl.mlp_apply(cfg, _layer0(tparams["layers"])["mlp"],
                        torch.tensor(x)),
           jl.mlp_apply(cfg, jax.tree.map(lambda a: a[0],
                                          params["layers"])["mlp"],
                        jnp.asarray(x)))


def _attn_pair(params, tparams):
    jp = jax.tree.map(lambda a: a[0], params["layers"])["attn"]
    tp = _layer0(tparams["layers"])["attn"]
    return jp, tp


@pytest.mark.parametrize("window", [0, 5])
def test_attn_apply_no_cache(model, window):
    cfg, params, tparams = model
    jp, tp = _attn_pair(params, tparams)
    x = np.random.default_rng(3).normal(size=(2, 12, cfg.d_model))
    x = x.astype(np.float32)
    out, cache = tl.attn_apply(cfg, tp, torch.tensor(x), window=window)
    ref, _ = jl.attn_apply(cfg, jp, jnp.asarray(x), window=window)
    assert cache is None
    _close(out, ref)


def test_attn_apply_scalar_cache_index(model):
    """Prefill of 6 tokens into a 10-slot cache at index 0, then one
    decode token at index 6: dynamic_update_slice semantics."""
    cfg, params, tparams = model
    jp, tp = _attn_pair(params, tparams)
    rng = np.random.default_rng(4)
    B, S, T = 2, 6, 10
    KH, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    jcache = {"k": jnp.zeros((B, T, KH, hd)), "v": jnp.zeros((B, T, KH, hd))}
    tcache = {"k": torch.zeros(B, T, KH, hd), "v": torch.zeros(B, T, KH, hd)}
    for idx, n in ((0, S), (S, 1)):
        x = rng.normal(size=(B, n, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(idx + np.arange(n), (B, n)).astype(np.int32)
        ref, jcache = jl.attn_apply(cfg, jp, jnp.asarray(x),
                                    positions=jnp.asarray(pos), cache=jcache,
                                    cache_index=idx)
        out, tcache = tl.attn_apply(cfg, tp, torch.tensor(x),
                                    positions=torch.tensor(pos),
                                    cache=tcache, cache_index=idx)
        _close(out, ref)
        _close(tcache["k"], jcache["k"])
        _close(tcache["v"], jcache["v"])


def test_attn_apply_vector_cache_index(model):
    """Per-row decode (continuous batching): row b writes at index[b] into
    a cache holding stale entries past it, which stay masked."""
    cfg, params, tparams = model
    jp, tp = _attn_pair(params, tparams)
    rng = np.random.default_rng(5)
    B, T = 3, 12
    KH, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    k0 = rng.normal(size=(B, T, KH, hd)).astype(np.float32)
    v0 = rng.normal(size=(B, T, KH, hd)).astype(np.float32)
    idx = np.asarray([2, 7, 11], np.int32)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    ref, jcache = jl.attn_apply(
        cfg, jp, jnp.asarray(x), positions=jnp.asarray(idx[:, None]),
        cache={"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
        cache_index=jnp.asarray(idx))
    out, tcache = tl.attn_apply(
        cfg, tp, torch.tensor(x), positions=torch.tensor(idx[:, None]),
        cache={"k": torch.tensor(k0), "v": torch.tensor(v0)},
        cache_index=torch.tensor(idx))
    _close(out, ref)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])


def test_vector_cache_index_needs_single_token(model):
    cfg, _, tparams = model
    tp = _layer0(tparams["layers"])["attn"]
    KH, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    cache = {"k": torch.zeros(2, 8, KH, hd), "v": torch.zeros(2, 8, KH, hd)}
    with pytest.raises(ValueError, match="single-token"):
        tl.attn_apply(cfg, tp, torch.zeros(2, 3, cfg.d_model), cache=cache,
                      cache_index=torch.tensor([0, 1]))


# ===========================================================================
# the whole model
# ===========================================================================
def _logits_pair(cfg, params, tparams, tokens, **kw):
    ref, _, _ = JT.apply(cfg, params, {"tokens": jnp.asarray(tokens)}, **kw)
    out, aux, _ = TT.apply(cfg, tparams, {"tokens": torch.tensor(tokens)},
                           **kw)
    assert aux == 0.0
    return out, ref


def test_apply_logits(model):
    cfg, params, tparams = model
    tokens = np.random.default_rng(6).integers(
        1, cfg.vocab_size, size=(2, 80)).astype(np.int64)
    out, ref = _logits_pair(cfg, params, tparams, tokens)
    _close(out, ref)
    last, last_ref = _logits_pair(cfg, params, tparams, tokens,
                                  last_only=True)
    _close(last, last_ref)
    _close(last, ref[:, -1:])


def test_apply_prefill_into_cache(model):
    """Prefill over a longer cache (tail masked), the serve path's
    prefill step: last-position logits and the written caches."""
    cfg, params, tparams = model
    B, S, T = 2, 9, 16
    tokens = np.random.default_rng(7).integers(
        1, cfg.vocab_size, size=(B, S)).astype(np.int64)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jc = JT.init_cache(cfg, B, T)
    tc = TT.init_cache(cfg, B, T, device="cpu")
    ref, _, jc = JT.apply(cfg, params, {"tokens": jnp.asarray(tokens),
                                       "positions": jnp.asarray(pos)},
                          caches=jc, cache_index=0, last_only=True)
    out, _, tc = TT.apply(cfg, tparams, {"tokens": torch.tensor(tokens),
                                         "positions": torch.tensor(pos)},
                          caches=tc, cache_index=0, last_only=True)
    _close(out, ref)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


def test_init_params_layout_matches_jax(model):
    """init_params keeps the JAX tree's keys and stacked (L, ...) leaves,
    so bridged and freshly drawn weights are interchangeable."""
    cfg, params, _ = model
    ours = TT.init_params(cfg, torch.Generator().manual_seed(0))
    shapes = lambda t: {k: shapes(v) if isinstance(v, dict) else
                        tuple(v.shape) for k, v in t.items()}
    assert shapes(ours) == shapes(jax.tree.map(np.asarray, params))
    kc = TT.init_cache(cfg, 2, 8, device="cpu")
    jc = JT.init_cache(cfg, 2, 8)
    assert {k: tuple(v.shape) for k, v in kc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}


def test_apply_full_width_qwen_two_layers():
    """qwen-1.5b's published widths (d_model 1536, 12/2 heads, hd 128,
    d_ff 8960) with 2 layers and the vocabulary cut to 4096."""
    cfg = dataclasses.replace(jconfigs.get_config("qwen-1.5b"),
                              num_layers=2, vocab_size=4096)
    params = JT.init_params(cfg, jax.random.PRNGKey(1))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu")
    tokens = np.random.default_rng(8).integers(
        1, cfg.vocab_size, size=(1, 24)).astype(np.int64)
    out, ref = _logits_pair(cfg, params, tparams, tokens)
    _close(out, ref, TOL_FULL)
