"""Mixture-of-Experts FFN: top-k token-choice routing with capacity, the
PyTorch counterpart of ``repro.models.moe``.

Dispatch is scatter-based (no (tokens, E, C) one-hot tensors): per group
each token's expert id and its position in that expert come from a
cumulative count, tokens are scattered into an (E, C, d) buffer, the
experts run as batched matmuls, and the results are gathered back.  A
token past its expert's capacity is dropped: it lands in the overflow slot
with a zero contribution and its output term is zero.

The buffer holds ``min(capacity, N)`` slots and the overflow slot after
them (N: a group's tokens in this call).  A token's slot is its position
among this call's tokens of its expert, so it is below N, and a slot that
no token takes holds zeros, whose expert output is zero (no biases) and is
never read: the outputs are the reference's, whose buffer has
``capacity`` slots, while a decode step of one token a row runs its
experts over 2 slots and not over the capacity of the whole cache.

Weight-stationary expert parallelism (``moe_apply_ep``): each rank holds
E/n experts and the router whole; every rank dispatches its tokens into a
global (E, C, d) buffer, rank j's experts receive slice j of every rank's
buffer, concatenated along the capacity axis, and send their results back
the same way (the two ``lax.all_to_all`` of ``repro.models.moe.
_moe_apply_ep``, here an exchange between the rank tensors of the one
controller).  The JAX package picks this path through a trace-time hook
(``set_ep_axis``); here the lockstep forward calls it, since the exchange
needs every rank's tensor at once.

``routing_rule`` holds two routings of the same tokens to each other, as
the tests and ``chip_smoke.py`` do: routing is discrete, so two float32
routes that differ in the last bit can pick other experts where two
probabilities are within rounding of each other.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.models.layers import activation_fn, dense_init

#: a routing disagreement where the neighbouring probabilities are further
#: apart than this is a fault (``routing_rule``)
ROUTING_MARGIN = 1e-5


def moe_params(gen, cfg, dtype, prefix_shape=()):
    """router (d, E); experts ``w_up`` and ``w_gate`` (E, d, f) and
    ``w_down`` (E, f, d), ``w_down`` scaled by 1/sqrt(L); ``w_gate`` only
    for a gated activation."""
    E, d, f = cfg.num_experts, cfg.d_model, cfg.resolved_moe_d_ff
    p = {
        "router": dense_init(gen, prefix_shape + (d, E), dtype),
        "w_up": dense_init(gen, prefix_shape + (E, d, f), dtype),
        "w_down": dense_init(gen, prefix_shape + (E, f, d), dtype,
                             scale=1.0 / max(1, cfg.num_layers) ** 0.5),
    }
    if cfg.activation in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, prefix_shape + (E, d, f), dtype)
    return p


def capacity_of(ref_len: int, cfg, cf: float) -> int:
    """Tokens each expert keeps of a group of ``ref_len`` tokens:
    ceil(ref_len * cf * k / E), at least 1."""
    E, k = cfg.num_experts, cfg.experts_per_token
    return max(1, int(-(-ref_len * cf * k // E)))


def _router(cfg, p, toks):
    """toks: (..., N, d) -> (top_w, top_i, aux, probs): softmax in float32,
    top-k, the weights renormalised by max(sum, 1e-9), and the Switch
    load-balance loss E * sum_e mean_prob_e * frac_e * router_aux_coef,
    ``frac`` the one-hot averaged over the tokens and the k slots."""
    E, k = cfg.num_experts, cfg.experts_per_token
    logits = (toks @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    red = tuple(range(probs.dim() - 1))
    frac = F.one_hot(top_i, E).float().mean(dim=red + (probs.dim() - 1,))
    aux = E * (probs.mean(dim=red) * frac).sum() * cfg.router_aux_coef
    return top_w, top_i, aux, probs


def _dispatch(toks, e_idx, E, capacity, prior=None):
    """toks (G, N, d), e_idx (G, N) -> (buf (G, E, C+1, d), slot, keep).
    ``prior`` (G, E): tokens routed to each expert by earlier calls over
    the same rows; it shifts the drop decision, not the buffer slot."""
    G, N, d = toks.shape
    onehot = F.one_hot(e_idx, E)
    within = torch.gather(onehot.cumsum(dim=1) - 1, 2,
                          e_idx[..., None])[..., 0]
    pos = within if prior is None else within + torch.gather(prior, 1,
                                                             e_idx)
    keep = pos < capacity
    over = min(capacity, N)  # the overflow slot
    slot = torch.where(keep, within, torch.full_like(within, over))
    buf = toks.new_zeros((G, E, over + 1, d))
    rows = torch.arange(G, device=toks.device)[:, None].expand(G, N)
    # each kept slot receives one token and the overflow slot only zeros,
    # so the accumulation order cannot change a bit: the result is
    # deterministic on the card too
    buf = buf.index_put((rows, e_idx, slot),
                        torch.where(keep[..., None], toks,
                                    torch.zeros_like(toks)),
                        accumulate=True)
    return buf, slot, keep


def _combine(buf_out, e_idx, slot, keep, gate_w):
    G, N = e_idx.shape
    rows = torch.arange(G, device=e_idx.device)[:, None].expand(G, N)
    out = buf_out[rows, e_idx, slot]
    return out * (gate_w * keep)[..., None]


def expert_ffn(cfg, p, buf):
    """buf (..., E_local, C, d) through the experts of ``p`` (E_local,
    ...): plain batched matmuls, as the reference computes them outside
    any Pallas kernel."""
    act = activation_fn(cfg.activation)
    up = torch.einsum("...ecd,edf->...ecf", buf, p["w_up"])
    if "w_gate" in p:
        h = act(torch.einsum("...ecd,edf->...ecf", buf, p["w_gate"])) * up
    else:
        h = act(up)
    return torch.einsum("...ecf,efd->...ecd", h, p["w_down"])


def moe_apply(cfg, p, x, *, capacity_factor: float = 0.0, groups: int = 0,
              router_counts=None, capacity_len: int = 0):
    """x (B, S, d) -> (out (B, S, d), aux), ``repro.models.moe.moe_apply``.

    groups: dispatch groups (0 = one per batch row), each with capacity
    ceil(group tokens * cf * k / E).  router_counts (B, k, E) int32 and
    capacity_len (incremental decode): the running tally of earlier calls
    over the same rows and the fixed length (the cache's) that the
    capacity is computed from, so that prefill plus decode drops what the
    full forward drops; groups must then be batch rows, and the updated
    tally comes back as a third element."""
    cf = capacity_factor or cfg.moe_capacity_factor
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    if router_counts is not None and groups not in (0, B):
        raise ValueError(
            f"incremental decode (router_counts) requires per-batch-row "
            f"dispatch groups; got groups={groups} for batch {B}")
    G = B if router_counts is not None else (groups or B)
    toks = x.reshape(G, (B * S) // G, d)
    Ng = toks.shape[1]
    ref_len = capacity_len if router_counts is not None else Ng
    capacity = capacity_of(ref_len, cfg, cf)

    top_w, top_i, aux, _ = _router(cfg, p, toks)
    out = torch.zeros_like(toks)
    new_counts = []
    for slot_k in range(k):
        e_idx = top_i[..., slot_k]
        g_w = top_w[..., slot_k].to(x.dtype)
        prior = None
        if router_counts is not None:
            prior = router_counts[:, slot_k, :]
            new_counts.append(prior + F.one_hot(e_idx, E).sum(
                dim=1, dtype=prior.dtype))
        buf, slot, keep = _dispatch(toks, e_idx, E, capacity, prior)
        out = out + _combine(expert_ffn(cfg, p, buf), e_idx, slot, keep,
                             g_w)
    out = out.reshape(B, S, d)
    if router_counts is not None:
        return out, aux, torch.stack(new_counts, dim=1)
    return out, aux


def moe_apply_ep(cfg, ps: Sequence[dict], xs: Sequence[torch.Tensor], *,
                 capacity_factor: float = 0.0, router_counts=None):
    """Weight-stationary expert parallelism over the ranks of one
    controller (``_moe_apply_ep`` of the reference): ``ps[r]`` holds rank
    r's E/n experts and the whole router, ``xs[r]`` (B, S, d) its tokens,
    one dispatch group of all of them.  Returns ([out], [aux]), one per
    rank.  The exchange is concatenations of slices, so autograd carries
    each expert's gradient back to the rank that holds it."""
    if router_counts is not None:
        raise ValueError("incremental decode (router_counts) is not "
                         "supported on the expert-parallel path")
    cf = capacity_factor or cfg.moe_capacity_factor
    n = len(xs)
    E, k = cfg.num_experts, cfg.experts_per_token
    El = ps[0]["w_up"].shape[0]
    if El * n != E:
        raise ValueError(f"{n} ranks of {El} experts each do not hold the "
                         f"{E} experts")
    N = xs[0].shape[0] * xs[0].shape[1]
    if any(x.shape[0] * x.shape[1] != N for x in xs):
        raise ValueError("the ranks' token counts differ: the exchanged "
                         "buffers must have one capacity")
    capacity = capacity_of(N, cfg, cf)
    toks = [x.reshape(1, N, x.shape[-1]) for x in xs]
    routed = [_router(cfg, p, t) for p, t in zip(ps, toks)]
    outs = [torch.zeros_like(t) for t in toks]
    for slot_k in range(k):
        sent = []
        for t, (top_w, top_i, _, _) in zip(toks, routed):
            buf, slot, keep = _dispatch(t, top_i[..., slot_k], E, capacity)
            sent.append((buf[0], slot, keep))
        C = sent[0][0].shape[1]
        # rank j receives slice j of every rank's buffer -> (E/n, n*C, d)
        recv = [torch.cat([b[j * El:(j + 1) * El].to(ps[j]["w_up"].device)
                           for b, _, _ in sent], dim=1) for j in range(n)]
        done = [expert_ffn(cfg, ps[j], recv[j]) for j in range(n)]
        for i in range(n):
            back = torch.cat([o[:, i * C:(i + 1) * C].to(xs[i].device)
                              for o in done], dim=0)
            top_w, top_i = routed[i][0], routed[i][1]
            _, slot, keep = sent[i]
            outs[i] = outs[i] + _combine(
                back[None], top_i[..., slot_k], slot, keep,
                top_w[..., slot_k].to(xs[i].dtype))
    return ([o.reshape(x.shape) for o, x in zip(outs, xs)],
            [r[2] for r in routed])


def routing_rule(top_a, top_b, probs, margin: float = ROUTING_MARGIN):
    """Two routings of the same tokens, ``top_a`` and ``top_b`` (..., k)
    expert ids, held to each other; ``probs`` (..., E) are one side's
    router probabilities.  A token whose routing differs is a near-tie
    when the top k+1 of its probabilities have two neighbours within
    ``margin``, else a fault.  Returns (faults, near_ties, tied): the
    counts, and a bool tensor over the leading dims (all but the token
    dim) that marks each group holding a near-tie, whose outputs the
    caller leaves out of its comparison."""
    k = top_a.shape[-1]
    diff = (top_a != top_b).any(dim=-1)
    top = torch.topk(probs.float(), min(k + 1, probs.shape[-1]),
                     dim=-1).values
    gap = (top[..., :-1] - top[..., 1:]).amin(dim=-1)
    near = diff & (gap <= margin)
    faults = int((diff & ~near).sum())
    return faults, int(near.sum()), near.any(dim=-1)

