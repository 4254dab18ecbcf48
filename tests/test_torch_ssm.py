"""The port's Mamba2 SSD modules against the JAX package, on the CPU.

* ``kernels.ssd_scan.ssd_scan_plain`` (the CUDA kernel's plain version,
  which CPU tensors take) against ``ssd_scan_pallas(..., interpret=True)``
  and against the jnp ``ssd_chunked``, at the four shapes of
  ``tests/test_kernels.py::test_ssd_scan_shapes``, float32 and bfloat16:
  |diff| <= tol * (1 + |ref|), tol 2e-4 and 5e-2, the reference's own
  kernel-vs-oracle tolerances (the sums over Q and n in another order;
  bfloat16 also rounds y once on each side).
* The port's ``ssd_chunked`` (the oracle, with an initial state) against
  the JAX one, 1e-5 relative: the same algorithm in f32, sums in another
  order.  Chunk invariance of the scan, and its gradient against
  ``jax.grad`` of the JAX scan.
* ``_causal_conv``, ``ssd_recurrent_step`` and ``mamba2_apply`` in its
  three branches (the train forward, prefill into a fresh cache with the
  chunk padding, and decode), with the JAX weights bridged over: 1e-5
  relative.

Inputs are numpy arrays from a seed, handed to both packages.  One torch
thread per test: these small tensors gain nothing from more.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.configs import get_reduced
from repro_torch.kernels import ssd_scan as K
from repro_torch.models import ssm as tssm

TOL = 1e-5
SCAN_TOL = {"float32": 2e-4, "bfloat16": 5e-2}
# the four shapes of the reference's kernel test: b, s, h, p, g, n, Q
SHAPES = [(2, 64, 4, 16, 1, 8, 16), (1, 128, 8, 32, 2, 16, 32),
          (2, 96, 6, 8, 3, 4, 32), (1, 64, 2, 64, 2, 64, 64)]


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


def _scan_inputs(b, s, h, p, g, n, seed=0):
    """x, dt, A, Bm, Cm as numpy f32, distributed as ``mamba2_apply``
    makes them (dt a softplus, A negative)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)) * 0.5
    dt = np.logaddexp(rng.normal(size=(b, s, h)), 0.0)
    A = -np.exp(rng.normal(size=(h,)) * 0.3)
    Bm = rng.normal(size=(b, s, g, n)) * 0.5
    Cm = rng.normal(size=(b, s, g, n)) * 0.5
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]


def _both(arrays, dtype):
    """The same inputs for both packages; x, Bm and Cm rounded to
    ``dtype`` (round to nearest even on both sides)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    j, t = [], []
    for i, a in enumerate(arrays):
        low = i in (0, 3, 4)
        j.append(jnp.asarray(a).astype(jdt) if low else jnp.asarray(a))
        t.append(torch.from_numpy(a).to(tdt) if low else torch.from_numpy(a))
    return j, t


# ===========================================================================
# the scan
# ===========================================================================
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,g,n,Q", SHAPES)
def test_plain_scan_matches_pallas_kernel_and_oracle(b, s, h, p, g, n, Q,
                                                     dtype):
    j, t = _both(_scan_inputs(b, s, h, p, g, n), dtype)
    y, st = K.ssd_scan_plain(*t, Q)
    assert y.dtype == t[0].dtype and st.dtype == torch.float32
    tol = SCAN_TOL[dtype]
    for ref in (ssd_scan_pallas(*j, chunk=Q, interpret=True),
                jssm.ssd_chunked(*j, Q)):
        _close(y.float(), np.asarray(ref[0], np.float32), tol)
        _close(st, ref[1], tol)


@pytest.mark.parametrize("b,s,h,p,g,n,Q", SHAPES)
def test_ssd_chunked_matches_jax_with_initial_state(b, s, h, p, g, n, Q):
    arrays = _scan_inputs(b, s, h, p, g, n, seed=1)
    s0 = np.random.default_rng(2).normal(size=(b, h, p, n)).astype(
        np.float32)
    for init in (None, s0):
        y, st = tssm.ssd_chunked(*map(torch.from_numpy, arrays), Q,
                                 None if init is None
                                 else torch.from_numpy(init))
        ry, rst = jssm.ssd_chunked(*map(jnp.asarray, arrays), Q,
                                   None if init is None
                                   else jnp.asarray(init))
        _close(y, ry)
        _close(st, rst)


def test_scan_is_chunk_invariant():
    """The chunked duality does not depend on the chunk size (the
    reference's ``test_ssd_scan_chunk_invariance``, 1e-4)."""
    t = list(map(torch.from_numpy, _scan_inputs(1, 64, 4, 16, 2, 8)))
    for fn in (K.ssd_scan, tssm.ssd_chunked):
        y16, st16 = fn(*t, 16)
        y64, st64 = fn(*t, 64)
        _close(y16, y64, 1e-4)
        _close(st16, st64, 1e-4)


def test_scan_wrapper_takes_the_plain_route_on_cpu_and_checks_shapes():
    t = list(map(torch.from_numpy, _scan_inputs(1, 96, 4, 16, 2, 8)))
    before = K.launches
    y, st = K.ssd_scan(*t, 32)
    ry, rst = K.ssd_scan_plain(*t, 32)
    assert torch.equal(y, ry) and torch.equal(st, rst)
    assert K.launches == before  # no kernel on a CPU tensor
    y, _ = K.ssd_scan(*t, 200)  # the chunk is min(chunk, s)
    assert torch.equal(y, K.ssd_scan_plain(*t, 96)[0])
    with pytest.raises(ValueError, match="divisible"):
        K.ssd_scan(*t, 64)
    with pytest.raises(ValueError, match="does not fit"):  # 4 % 3 heads
        K.ssd_scan(*t[:3], torch.zeros(1, 96, 3, 8), t[4], 32)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        K.ssd_scan(*[x.to("meta") for x in t], 32)


def test_plain_scan_gradient_matches_jax():
    """The wrapper's gradient on the CPU (the plain forward, the backward
    through ``ssd_chunked``, as on the card) against ``jax.grad`` of the
    jnp scan, every input:
    |diff| <= 1e-4 * max|ref| per input, sums over the chunk's positions
    in another order."""
    arrays = _scan_inputs(1, 64, 4, 16, 2, 8, seed=3)
    rng = np.random.default_rng(4)
    gy = rng.normal(size=(1, 64, 4, 16)).astype(np.float32)
    gs = rng.normal(size=(1, 4, 16, 8)).astype(np.float32)

    def f(*a):
        y, st = jssm.ssd_chunked(*a, 16)
        return jnp.sum(y * gy) + jnp.sum(st * gs)

    ref = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y, st = K.ssd_scan(*leaves, 16)
    torch.autograd.backward([y, st], [torch.from_numpy(gy),
                                      torch.from_numpy(gs)])
    for t, r in zip(leaves, ref):
        r = np.asarray(r)
        err = np.abs(t.grad.numpy() - r).max()
        assert err <= 1e-4 * np.abs(r).max(), float(err)


def test_ssd_impl_hook_swaps_and_restores():
    prev = tssm.set_ssd_impl(tssm.ssd_chunked)
    try:
        assert prev is K.ssd_scan
        assert tssm._SSD_IMPL is tssm.ssd_chunked
    finally:
        assert tssm.set_ssd_impl(None) is tssm.ssd_chunked
    assert tssm._SSD_IMPL is K.ssd_scan


# ===========================================================================
# the mixer
# ===========================================================================
@pytest.fixture(scope="module")
def mixer():
    """Reduced mamba2's config and one layer's mixer weights, as JAX draws
    them and bridged to the port, with A_log, dt_bias and D moved off
    their init values so that every term of the mixer counts."""
    cfg = jconfigs.get_reduced("mamba2-2.7b")
    p = jssm.mamba2_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    rng = np.random.default_rng(5)
    for name in ("A_log", "dt_bias", "D", "conv_b", "gate_norm"):
        p[name] = p[name] + jnp.asarray(
            rng.normal(size=p[name].shape).astype(np.float32) * 0.3)
    return cfg, p, bridge.params_from_numpy(jax.tree.map(np.asarray, p),
                                            "cpu")


def test_mamba2_params_match_the_reference_layout():
    cfg = get_reduced("mamba2-2.7b")
    ours = tssm.mamba2_params(torch.Generator().manual_seed(0), cfg,
                              torch.float32, (3,))
    ref = jssm.mamba2_params(jax.random.PRNGKey(0), cfg, jnp.float32, (3,))
    assert set(ours) == set(ref)
    for k in ref:
        assert tuple(ours[k].shape) == ref[k].shape, k
        if k in ("conv_b", "dt_bias", "A_log", "D", "gate_norm"):
            np.testing.assert_array_equal(ours[k].numpy(), ref[k])


def test_causal_conv():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    _close(tssm._causal_conv(*map(torch.from_numpy, (x, w, b))),
           jssm._causal_conv(*map(jnp.asarray, (x, w, b))))


def test_ssd_recurrent_step():
    rng = np.random.default_rng(7)
    b, h, p, g, n = 3, 6, 8, 3, 4
    arrays = [rng.normal(size=s).astype(np.float32) for s in
              ((b, h, p), (b, h), (h,), (b, g, n), (b, g, n), (b, h, p, n))]
    arrays[1] = np.logaddexp(arrays[1], 0.0).astype(np.float32)
    arrays[2] = -np.exp(arrays[2])
    y, st = tssm.ssd_recurrent_step(*map(torch.from_numpy, arrays))
    ry, rst = jssm.ssd_recurrent_step(*map(jnp.asarray, arrays))
    _close(y, ry)
    _close(st, rst)


@pytest.mark.parametrize("S", [64, 45])
def test_mamba2_apply_train_forward(mixer, S):
    """No cache: the train forward (S = 45 pads to the chunk of 32 with
    dt = 0 steps)."""
    cfg, p, tp = mixer
    x = np.random.default_rng(8).normal(size=(2, S, cfg.d_model)).astype(
        np.float32)
    out, cache = tssm.mamba2_apply(cfg, tp, torch.from_numpy(x))
    ref, rcache = jssm.mamba2_apply(cfg, p, jnp.asarray(x))
    assert cache is None and rcache is None
    _close(out, ref)


@pytest.mark.parametrize("S", [40, 2])
def test_mamba2_prefill_then_decode_matches_jax(mixer, S):
    """Prefill of S tokens into a fresh cache (S = 40 pads the chunk; S = 2
    is shorter than the conv window), then two decode steps: the outputs
    and both new caches against the JAX mixer's, and the cache passed in
    left as it was."""
    cfg, p, tp = mixer
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, S + 2, cfg.d_model)).astype(np.float32)
    cache = tssm.init_ssm_cache(cfg, 3, device="cpu")
    rcache = jssm.init_ssm_cache(cfg, 3)
    for sl in (slice(0, S), slice(S, S + 1), slice(S + 1, S + 2)):
        before = {k: v.clone() for k, v in cache.items()}
        out, new = tssm.mamba2_apply(cfg, tp, torch.from_numpy(x[:, sl]),
                                     cache=cache)
        ref, rcache = jssm.mamba2_apply(cfg, p, jnp.asarray(x[:, sl]),
                                        cache=rcache)
        _close(out, ref)
        for k in ("conv", "ssm"):
            assert new[k].dtype == cache[k].dtype
            assert torch.equal(cache[k], before[k])
            _close(new[k], rcache[k])
        cache = new
