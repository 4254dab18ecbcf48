"""Attention in the PyTorch port against the JAX package, on the CPU.

``repro_torch.kernels.flash_attention.flash_attention_plain`` (what the
wrapper runs on a CPU tensor) and the port's ``blockwise_attention`` are
held to ``flash_attention_pallas`` in interpret mode and to the JAX
``blockwise_attention``, on the cases of ``tests/test_kernels.py``'s flash
sweep and ``tests/test_flash_masking.py``.  Inputs are numpy arrays from a
seed, handed to both.  Tolerance: float32, |diff| <= 1e-5 * (1 + |ref|)
(the two sides sum dot products and softmax terms in different orders).
Rows whose every key is masked have no defined answer (the result averages
V over the padded length, which depends on the block size even within
JAX), so every comparison holds only rows with at least one valid key.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import layers as jl
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as tl

TOL = 1e-5
PAD = -(10 ** 9)


def _inputs(seed, B, S, T, H, KH, hd, *, q_start=0, kv_valid=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, KH, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, KH, hd)).astype(np.float32)
    qp = np.broadcast_to(q_start + np.arange(S), (B, S)).astype(np.int32)
    kp = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32).copy()
    if kv_valid is not None:
        kp[np.arange(T)[None, :] > np.asarray(kv_valid)[:, None]] = PAD
    return q, k, v, qp, kp


def _packed(seed, B=1, S=64, H=2, KH=1, hd=16, pad=12):
    """Two packed segments and a padding tail (segment -1, position -1e9),
    as in tests/test_flash_masking.py."""
    q, k, v, _, _ = _inputs(seed, B, S, S, H, KH, hd)
    pos = np.zeros((B, S), np.int32)
    seg = np.full((B, S), -1, np.int32)
    cut = (S - pad) // 2
    pos[:, :cut] = np.arange(cut)
    seg[:, :cut] = 0
    pos[:, cut:S - pad] = np.arange(S - pad - cut)
    seg[:, cut:S - pad] = 1
    pos[:, S - pad:] = PAD
    return q, k, v, pos, seg


def _valid_rows(qp, kp, qs, ks, causal, window):
    mask = fa.attn_mask(torch.tensor(qp), torch.tensor(kp),
                        None if qs is None else torch.tensor(qs),
                        None if ks is None else torch.tensor(ks),
                        causal=causal, window=window)
    return mask.any(-1).numpy()


def _close(out, ref, rows):
    out = np.asarray(out, np.float32)[rows]
    ref = np.asarray(ref, np.float32)[rows]
    assert np.isfinite(out).all()
    err = np.abs(out - ref)
    assert (err <= TOL * (1 + np.abs(ref))).all(), float(err.max())


def _both(q, k, v, qp, kp, qs=None, ks=None, *, causal=True, window=0,
          softcap=0.0, blk=16):
    """(port plain, pallas interpret, jax blockwise) on the same inputs."""
    t = lambda x: None if x is None else torch.tensor(x)
    j = lambda x: None if x is None else jnp.asarray(x)
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    plain = fa.flash_attention_plain(
        t(q), t(k), t(v), q_positions=t(qp), kv_positions=t(kp),
        q_segment_ids=t(qs), kv_segment_ids=t(ks), **kw).numpy()
    pallas = flash_attention_pallas(
        j(q), j(k), j(v), q_positions=j(qp), kv_positions=j(kp),
        q_segment_ids=j(qs), kv_segment_ids=j(ks), blk_q=blk, blk_k=blk,
        interpret=True, **kw)
    block = jl.blockwise_attention(
        j(q), j(k), j(v), q_positions=j(qp), kv_positions=j(kp),
        q_segment_ids=j(qs), kv_segment_ids=j(ks), block_kv=blk, **kw)
    rows = _valid_rows(qp, kp, qs, ks, causal, window)
    return plain, pallas, block, rows


# ===========================================================================
# the flash sweep of tests/test_kernels.py
# ===========================================================================
@pytest.mark.parametrize("B,S,T,H,KH,hd", [
    (2, 64, 64, 4, 2, 32),
    (1, 96, 96, 4, 4, 32),   # MHA
    (2, 64, 64, 8, 2, 64),   # GQA 4:1
    (1, 60, 60, 2, 1, 16),   # lengths off the block multiple
])
def test_plain_matches_pallas_shapes(B, S, T, H, KH, hd):
    plain, pallas, block, rows = _both(*_inputs(0, B, S, T, H, KH, hd),
                                       blk=32)
    _close(plain, pallas, rows)
    _close(plain, block, rows)


@pytest.mark.parametrize("window,softcap,causal", [
    (16, 0.0, True), (0, 50.0, True), (32, 30.0, True), (0, 0.0, False),
])
def test_plain_matches_pallas_features(window, softcap, causal):
    B, S, H, KH, hd = 2, 64, 4, 2, 32
    q, k, v, qp, kp = _inputs(1, B, S, S, H, KH, hd)
    seg = np.concatenate([np.zeros((B, S // 2), np.int32),
                          np.ones((B, S - S // 2), np.int32)], axis=1)
    plain, pallas, block, rows = _both(q, k, v, qp, kp, seg, seg,
                                       causal=causal, window=window,
                                       softcap=softcap, blk=32)
    _close(plain, pallas, rows)
    _close(plain, block, rows)


# ===========================================================================
# the masking cases of tests/test_flash_masking.py, and decode
# ===========================================================================
def test_packed_padding():
    q, k, v, pos, seg = _packed(0)
    plain, pallas, block, rows = _both(q, k, v, pos, pos, seg, seg)
    assert not rows[:, -12:].any()  # the padding tail is fully masked
    _close(plain, pallas, rows)
    _close(plain, block, rows)


@pytest.mark.parametrize("window", [8, 24, 40])
def test_window_straddles_block_edge(window):
    q, k, v, pos, seg = _packed(2, pad=0)
    plain, pallas, block, rows = _both(q, k, v, pos, pos, seg, seg,
                                       window=window)
    _close(plain, pallas, rows)
    _close(plain, block, rows)


def test_gqa_matches_repeated_kv():
    q, k, v, qp, kp = _inputs(3, 1, 64, 64, 4, 2, 16)
    plain, pallas, block, rows = _both(q, k, v, qp, kp)
    _close(plain, pallas, rows)
    rep = fa.flash_attention_plain(
        torch.tensor(q), torch.tensor(np.repeat(k, 2, 2)),
        torch.tensor(np.repeat(v, 2, 2)), q_positions=torch.tensor(qp),
        kv_positions=torch.tensor(kp))
    assert torch.equal(torch.tensor(plain), rep)  # grouping is indexing


@pytest.mark.parametrize("index", [[5, 5], [3, 40]])
def test_decode_over_masked_tail(index):
    """S = 1 against a 48-slot cache written up to each row's index (the
    tail arrives as position -1e9), GQA 6:1 as in qwen."""
    B, T = 2, 48
    q, k, v, _, kp = _inputs(4, B, 1, T, 12, 2, 32, kv_valid=index)
    qp = np.asarray(index, np.int32)[:, None]
    plain, pallas, block, rows = _both(q, k, v, qp, kp)
    assert rows.all()
    _close(plain, pallas, rows)
    _close(plain, block, rows)


@pytest.mark.parametrize("S,T", [(77, 131), (33, 50), (1, 37)])
def test_ragged_lengths(S, T):
    """S and T off every block multiple; queries sit at the end of the
    keys, as in prefill over a longer cache."""
    q, k, v, qp, kp = _inputs(5, 2, S, T, 4, 2, 32, q_start=T - S)
    plain, pallas, block, rows = _both(q, k, v, qp, kp)
    _close(plain, pallas, rows)
    _close(plain, block, rows)


def test_port_blockwise_matches_jax_blockwise():
    """The port's reference algorithm, at a kv block that splits T
    unevenly, against the JAX scan and the plain version."""
    q, k, v, pos, seg = _packed(6, B=2, S=48, H=4, KH=2, hd=32, pad=5)
    kw = dict(causal=True, window=20, logit_softcap=30.0)
    t = torch.tensor
    ours = tl.blockwise_attention(
        t(q), t(k), t(v), q_positions=t(pos), kv_positions=t(pos),
        q_segment_ids=t(seg), kv_segment_ids=t(seg), block_kv=20, **kw)
    plain, _, block, rows = _both(q, k, v, pos, pos, seg, seg, causal=True,
                                  window=20, softcap=30.0, blk=20)
    _close(ours.numpy(), block, rows)
    _close(ours.numpy(), plain, rows)


# ===========================================================================
# the wrapper: plain on the CPU, nothing else
# ===========================================================================
def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    q, k, v, qp, kp = _inputs(7, 2, 16, 24, 4, 2, 32, q_start=8)
    t = torch.tensor
    before = fa.launches
    out = fa.flash_attention(t(q), t(k), t(v), q_positions=t(qp),
                             kv_positions=t(kp), logit_softcap=20.0)
    ref = fa.flash_attention_plain(t(q), t(k), t(v), q_positions=t(qp),
                                   kv_positions=t(kp), logit_softcap=20.0)
    assert torch.equal(out, ref)
    assert fa.launches == before


def test_wrapper_refuses_other_devices():
    q = torch.zeros(1, 4, 2, 32, device="meta")
    k = torch.zeros(1, 4, 1, 32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(q, k, k)


@pytest.mark.parametrize("qshape,kshape,dtype,err", [
    ((1, 4, 2, 48), (1, 4, 1, 48), torch.float32, ValueError),   # head dim
    ((1, 4, 3, 32), (1, 4, 2, 32), torch.float32, ValueError),   # H % KH
    ((1, 4, 2, 32), (1, 4, 1, 32), torch.float16, TypeError),    # dtype
])
def test_kernel_input_checks(qshape, kshape, dtype, err):
    """What the CUDA route checks before it launches."""
    q = torch.zeros(qshape, dtype=dtype)
    k = torch.zeros(kshape, dtype=dtype)
    with pytest.raises(err):
        fa._check(q, k, k)
