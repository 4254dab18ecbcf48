"""The port's ``models.moe`` against ``repro.models.moe``, on the CPU.

Reduced grok-1-314b (4 experts, top-2, gelu) and reduced
llama4-maverick-400b-a17b (4 experts, top-1, swiglu), d_model 128, expert
width 256; one expert bank drawn by the JAX ``moe_params`` and bridged.

* ``moe_apply`` with ``groups`` 0 (one group per batch row) and 2, at
  capacity factor 1.0 (tokens dropped: the test checks that some are) and
  8.0 (none dropped): the routing first, by ``moe.routing_rule`` (a
  disagreement is a fault unless two of the token's top k+1 probabilities
  lie within ``ROUTING_MARGIN``; a group holding such a near-tie is left
  out of the output comparison), then the outputs within TOL of 1 + |ref|
  and the aux loss within TOL relative.
* Prefill of S-1 tokens and one decode step with ``router_counts`` and
  ``capacity_len`` = S: the tallies equal the JAX ones, and the decode
  token's output equals the full forward's last position.
* The two refusals of the reference (multi-row groups with a tally, the
  expert-parallel path with a tally), with its messages.
* ``moe_apply_ep`` over 2 and 4 ranks (each rank's tree its E/n experts)
  against ``moe_apply`` with one group per rank, drops included, and its
  gradient reaching each rank's own experts.

Tolerance, float32: TOL = 1e-5.  One torch thread per test.
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
from repro.models import moe as jmoe
from repro_torch import bridge
from repro_torch.models import moe as tmoe

TOL = 1e-5
ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b")


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(arch, cf):
    return dataclasses.replace(jconfigs.get_reduced(arch),
                               moe_capacity_factor=cf)


@pytest.fixture(scope="module", params=ARCHS)
def bank(request):
    cfg = jconfigs.get_reduced(request.param)
    p = jmoe.moe_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    return request.param, p, bridge.params_from_numpy(
        jax.tree.map(np.asarray, p), "cpu")


def _x(cfg, B=4, S=24, seed=0):
    """Tokens that share one direction, so that the router favours some
    experts over others and capacity 1.0 drops tokens even at top-2
    (where each slot's capacity is twice a uniform share)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, cfg.d_model)) \
        + 2.0 * rng.normal(size=(1, 1, cfg.d_model))
    return x.astype(np.float32)


def _close(out, ref, tol=TOL, rows=None):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    if rows is not None:
        out, ref = out[rows], ref[rows]
    err = np.abs(out - ref)
    assert (err <= tol * (1 + np.abs(ref))).all(), float(err.max())


def _routing(cfg, p, tp, toks):
    """The routing rule on the same (G, N, d) tokens through both routers:
    returns the groups without a near-tie; fails on a fault."""
    _, j_top, _ = jmoe._router(cfg, p, jnp.asarray(toks))
    _, t_top, _, probs = tmoe._router(cfg, tp, torch.tensor(toks))
    faults, near, tied = tmoe.routing_rule(
        t_top, torch.tensor(np.asarray(j_top)).long(), probs)
    assert faults == 0, f"{faults} routing faults beyond the margin"
    return ~tied.numpy(), near


def _kept(cfg, tp, toks, cf):
    """How many (token, slot) pairs keep their expert at factor cf."""
    _, top_i, _, _ = tmoe._router(cfg, tp, torch.tensor(toks))
    cap = tmoe.capacity_of(toks.shape[1], cfg, cf)
    kept = 0
    for k in range(cfg.experts_per_token):
        _, _, keep = tmoe._dispatch(torch.tensor(toks), top_i[..., k],
                                    cfg.num_experts, cap)
        kept += int(keep.sum())
    return kept


@pytest.mark.parametrize("cf", [1.0, 8.0])
@pytest.mark.parametrize("groups", [0, 2])
def test_moe_apply_matches_jax(bank, cf, groups):
    arch, p, tp = bank
    cfg = _cfg(arch, cf)
    x = _x(cfg)
    B, S, d = x.shape
    G = groups or B
    toks = x.reshape(G, B * S // G, d)
    ok, _ = _routing(cfg, p, tp, toks)
    total = B * S * cfg.experts_per_token
    kept = _kept(cfg, tp, toks, cf)
    assert (kept < total) if cf == 1.0 else (kept == total), (kept, total)
    ref, raux = jmoe.moe_apply(cfg, p, jnp.asarray(x), groups=groups)
    out, aux = tmoe.moe_apply(cfg, tp, torch.tensor(x), groups=groups)
    rows = np.repeat(ok, B // G)
    _close(out.reshape(B, S, d), ref, rows=rows)
    assert abs(float(aux) - float(raux)) <= TOL * abs(float(raux))


@pytest.mark.parametrize("cf", [1.0, 8.0])
def test_prefill_and_decode_tally_match_the_full_forward(bank, cf):
    arch, p, tp = bank
    cfg = _cfg(arch, cf)
    x = _x(cfg, seed=1)
    B, S, _ = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    ok, _ = _routing(cfg, p, tp, x)
    full, _ = tmoe.moe_apply(cfg, tp, torch.tensor(x))
    jfull, _ = jmoe.moe_apply(cfg, p, jnp.asarray(x))
    zeros = np.zeros((B, k, E), np.int32)
    pre, _, counts = tmoe.moe_apply(
        cfg, tp, torch.tensor(x[:, :S - 1]),
        router_counts=torch.from_numpy(zeros), capacity_len=S)
    jpre, _, jcounts = jmoe.moe_apply(
        cfg, p, jnp.asarray(x[:, :S - 1]), router_counts=jnp.asarray(zeros),
        capacity_len=S)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    dec, _, counts2 = tmoe.moe_apply(
        cfg, tp, torch.tensor(x[:, S - 1:]), router_counts=counts,
        capacity_len=S)
    _, _, jcounts2 = jmoe.moe_apply(
        cfg, p, jnp.asarray(x[:, S - 1:]), router_counts=jcounts,
        capacity_len=S)
    np.testing.assert_array_equal(counts2.numpy(), np.asarray(jcounts2))
    assert int(counts2.sum()) == B * S * k
    _close(pre, jpre, rows=ok)
    _close(dec[:, 0], full[:, -1], rows=ok)
    _close(dec[:, 0], jfull[:, -1], rows=ok)


def test_the_two_refusals(bank):
    arch, p, tp = bank
    cfg = jconfigs.get_reduced(arch)
    x = torch.tensor(_x(cfg, B=4, S=3))
    counts = torch.zeros((4, cfg.experts_per_token, cfg.num_experts),
                         dtype=torch.int32)
    with pytest.raises(ValueError, match="per-batch-row") as ours:
        tmoe.moe_apply(cfg, tp, x, groups=2, router_counts=counts,
                       capacity_len=3)
    with pytest.raises(ValueError) as ref:
        jmoe.moe_apply(cfg, p, jnp.asarray(x.numpy()), groups=2,
                       router_counts=jnp.asarray(counts.numpy()),
                       capacity_len=3)
    assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="expert-parallel path"):
        tmoe.moe_apply_ep(cfg, [tp], [x], router_counts=counts)


def _shards(tp, n):
    """Rank r's tree: experts r*E/n..(r+1)*E/n, the router whole."""
    return [{k: (v.chunk(n, 0)[r].clone() if k != "router" else v.clone())
             .requires_grad_(True) for k, v in tp.items()} for r in range(n)]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("cf", [1.0, 8.0])
def test_expert_parallel_exchange_matches_one_group_per_rank(bank, n, cf):
    arch, p, tp = bank
    cfg = _cfg(arch, cf)
    xs = [torch.tensor(_x(cfg, B=2, S=12, seed=10 + r)) for r in range(n)]
    ps = _shards(tp, n)
    outs, auxs = tmoe.moe_apply_ep(cfg, ps, xs)
    full = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    total = 0.0
    for r, x in enumerate(xs):
        ref, raux = tmoe.moe_apply(cfg, full, x, groups=1)
        _close(outs[r].detach(), ref.detach())
        assert abs(float(auxs[r].detach()) - float(raux.detach())) \
            <= TOL * abs(float(raux.detach()))
        total = total + (ref * (r + 1)).sum()
    sum((o * (r + 1)).sum() for r, o in enumerate(outs)).backward()
    total.backward()
    for name in ("w_up", "w_down"):
        want = full[name].grad.chunk(n, 0)
        for r in range(n):
            got = ps[r][name].grad
            assert got is not None and got.shape == want[r].shape
            _close(got, want[r], tol=1e-4)
