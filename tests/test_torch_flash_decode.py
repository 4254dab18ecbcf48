"""The flash-attention decode path's algorithm against the JAX package, on
the CPU.

``repro_torch.kernels.flash_attention.flash_decode_split_plain`` repeats
what the decode kernel does: the keys cut into 64-key tiles, tile t to
split t % n (n = 8 blocks a cluster, fewer for many kv heads), each
split's online-softmax partial, and the merge of the partials in split
order.  It is held to ``flash_attention_pallas`` in interpret mode and
to ``flash_attention_plain``, on numpy inputs from a seed: GQA groups of 1 and 6, every head dim, caches shorter than one
tile, off the tile multiple and shorter than the 8 splits' tiles, a
split with nothing to do, per-row cache indices, a window, a soft cap,
segment ids, and 16 and 32 kv heads (4 and 2 splits).  Tolerance, float32: |diff| <= 1e-5 * (1 + |ref|) on
rows with at least one valid key (the three sum the dot products and
softmax terms in different orders).  One torch thread, so that the
sums do not change order with the machine.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as fa

TOL = 1e-5
PAD = -(10 ** 9)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, B, S, T, KH, G, hd, *, last, segments=False):
    """q at the cache index ``last[b]`` (S rows ending there), the cache
    written up to it (later slots at position -1e9, as the serve path's
    masked tail)."""
    rng = np.random.default_rng(seed)
    H = KH * G
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, KH, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, KH, hd)).astype(np.float32)
    last = np.asarray(last)
    qp = (last[:, None] - S + 1 + np.arange(S)).astype(np.int32)
    kp = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32).copy()
    kp[kp > last[:, None]] = PAD
    kw = dict(q_positions=qp, kv_positions=kp)
    if segments:  # the query's segment starts at a third of its cache
        ks = (np.arange(T)[None, :] >= last[:, None] // 3).astype(np.int32)
        kw.update(q_segment_ids=np.ones((B, S), np.int32),
                  kv_segment_ids=np.broadcast_to(ks, (B, T)).copy())
    return q, k, v, kw


def _check(q, k, v, kw, *, causal=True, window=0, softcap=0.0):
    t = lambda x: torch.tensor(x)
    opts = dict(causal=causal, window=window, logit_softcap=softcap)
    tkw = {n: t(x) for n, x in kw.items()}
    split = fa.flash_decode_split_plain(t(q), t(k), t(v), **tkw,
                                        **opts).numpy()
    plain = fa.flash_attention_plain(t(q), t(k), t(v), **tkw, **opts).numpy()
    pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        **{n: jnp.asarray(x) for n, x in kw.items()}, blk_q=16,
        blk_k=fa.DECODE_TILE, interpret=True, **opts))
    rows = fa.attn_mask(tkw["q_positions"], tkw["kv_positions"],
                        tkw.get("q_segment_ids"), tkw.get("kv_segment_ids"),
                        causal=causal, window=window).any(-1).numpy()
    assert rows.any()
    for ref in (pallas, plain):
        o, r = split[rows], ref[rows]
        assert np.isfinite(o).all()
        err = np.abs(o - r)
        assert (err <= TOL * (1 + np.abs(r))).all(), float(err.max())


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("G", [1, 6])
def test_split_matches_pallas_and_plain(G, hd):
    """700 slots: 11 tiles, so splits 0-2 take two tiles each and the last
    is ragged; per-row cache indices, the second row's leaving splits
    3-7 with nothing to do."""
    _check(*_case(0, 2, 1, 700, 2 if G == 1 else 1, G, hd, last=[650, 190]))


@pytest.mark.parametrize("T,last", [
    (40, [39, 12]),     # below one tile: splits 1-7 have no keys at all
    (200, [199, 64]),   # off the tile multiple, fewer tiles than splits
    (512, [511, 300]),  # exactly one tile a split
    (600, [70, 70]),    # splits 2-7 wholly masked (the tail past 70)
])
def test_split_cache_edges(T, last):
    _check(*_case(1, 2, 1, T, 2, 6, 64, last=last))


@pytest.mark.parametrize("S,G", [(2, 6), (16, 1), (8, 1)])
def test_split_several_query_rows(S, G):
    """Up to the decode path's 16 rows a (batch, kv head): S positions x G
    heads, causal among themselves."""
    _check(*_case(2, 2, S, 300, 2, G, 32, last=[299, 150]))


@pytest.mark.parametrize("window,softcap,segments", [
    (96, 0.0, False), (0, 30.0, False), (0, 0.0, True), (200, 50.0, True)])
def test_split_window_softcap_segments(window, softcap, segments):
    _check(*_case(3, 2, 1, 700, 1, 6, 128, last=[690, 333],
                  segments=segments), window=window, softcap=softcap)


def test_split_non_causal():
    _check(*_case(4, 1, 4, 260, 2, 1, 64, last=[259]), causal=False)


def test_wholly_masked_split_is_the_fresh_carry():
    """A split with no valid (row, key) pair contributes exactly
    (NEG_INF, 0, 0): the merge of the other splits alone gives the same
    output bit for bit."""
    q, k, v, kw = _case(5, 1, 1, 600, 1, 6, 32, last=[100])
    t = {n: torch.tensor(x) for n, x in kw.items()}
    full = fa.flash_decode_split_plain(torch.tensor(q), torch.tensor(k),
                                       torch.tensor(v), **t)
    # keys 0-127 are tiles 0 and 1 (splits 0 and 1); the rest is masked
    head = fa.flash_decode_split_plain(
        torch.tensor(q), torch.tensor(k[:, :128]), torch.tensor(v[:, :128]),
        q_positions=t["q_positions"], kv_positions=t["kv_positions"][:, :128])
    assert torch.equal(full, head)


@pytest.mark.parametrize("KH", [16, 32])
def test_split_with_many_kv_heads(KH):
    """MHA: 4 splits at 16 kv heads, 2 at 32, each taking every fourth
    or second tile of a 700-slot cache."""
    _check(*_case(6, 1, 1, 700, KH, 1, 32, last=[600]))


def test_decode_rows_threshold_and_split():
    assert [fa.decode_rows(hd) for hd in fa.HEAD_DIMS] == [16, 16, 16, 8]
    assert [fa.decode_split(kh) for kh in (1, 2, 8, 9, 16, 32, 64)] == [
        8, 8, 8, 4, 4, 2, 1]
