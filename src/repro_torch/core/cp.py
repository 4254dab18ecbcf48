"""Context parallelism: ring attention over the cp groups of a
``RankGroup``, the counterpart of ``repro.core.cp``.

The (data, cp) layout (``core.ranks.cp_groups``): rank ``d*cp + c`` is
position c of group d, and each group sequence-shards its rows over its
cp ranks.  Everything outside attention is position-local, so only
attention crosses ranks: every rank keeps its q shard, and the group's
k and v circulate around the group's ring (``kernels.odc_gather``: the
hand-written ring kernel on the card, the plain ring on the CPU, as the
JAX package's ``gather_impl='kernel'`` and ``'jnp'``).

Head+tail interleave.  Under a causal mask a contiguous split gives the
last rank about twice the unmasked score area of the first; the packed
rows are therefore laid out by ``interleave_indices`` (the loader does it
in ``data.packing.build_minibatch``), so that rank r of n holds global
chunks r and 2n-1-r.  Masking is by the true global positions, which
travel with the keys, so the layout changes no result.

``ring_attention`` is one ``torch.autograd.Function`` over all ranks of a
group: the single controller's form of ``_ring_attn``.  Forward: the
group's keys, values, positions and segment ids are ring-gathered, put
back in global order, and the ``2*cp`` chunks (cp without interleave) are
swept in ascending global order through ``kernels.flash_attention_state``
from a fresh carry, then ``finish_attention``.  On the card, with every
chunk a multiple of the kernel's kv tile, that equals the monolithic
kernel on the gathered sequence bit for bit (the kernel source says
why).  Backward: q and the cotangents are ring-gathered too and
``flash_attention_bwd`` (the port of ``flash_attention_bwd_ref``, the VJP
of ``flash_attention_diff``) runs on the whole sequence, each rank's
slice is then cut back out.  The JAX package runs that backward on every
rank of the group on identical gathered inputs; the single controller
runs it once per group and hands each rank its slice: the same values,
at 1/cp of the work and memory.

``allgather_attention`` is the ring's plain version (``allgather_attention``
of the JAX package): keys and values concatenated over the group, and
``flash_attention_plain`` of each rank's q against them, differentiated
by autograd.  The tests and the card's comparisons use it; the train path
does not.  The port's windows are always Python ints
(``transformer.layer_window``), so the JAX ``cp_attention_impl``'s
fallback to it for a traced window has no counterpart here.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.kernels import odc_gather as kgather
from repro_torch.kernels.flash_attention import (BWD_LABEL,
                                                 finish_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_plain,
                                                 flash_attention_state)


# ---------------------------------------------------------------------------
# head+tail interleaved chunk layout
# ---------------------------------------------------------------------------
def interleave_indices(total: int, cp: int) -> np.ndarray:
    """Device-layout order of global sequence indices: the sequence cut
    into ``2*cp`` equal chunks, rank r's shard [chunk r, chunk 2*cp-1-r].
    ``x_device_layout = x_global[perm]``."""
    if total % (2 * cp):
        raise ValueError(f"sequence length {total} is not a multiple of "
                         f"2 * cp = {2 * cp}")
    chunk = total // (2 * cp)
    idx = np.arange(total).reshape(2 * cp, chunk)
    order = []
    for r in range(cp):
        order += [r, 2 * cp - 1 - r]
    return idx[order].reshape(-1)


def unshuffle_indices(total: int, cp: int) -> np.ndarray:
    """Inverse of ``interleave_indices``:
    ``x_global = x_device_layout[unshuffle_indices(total, cp)]``."""
    perm = interleave_indices(total, cp)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(total)
    return inv


def _unshuffle_gathered(x: torch.Tensor, cp: int) -> torch.Tensor:
    """Ring-gathered (device order) -> global order along the leading
    axis: rank r's pair is (chunk r, chunk 2n-1-r), so the head chunks are
    [:, 0] ascending and the tail chunks [:, 1] descending."""
    n = cp
    chunk = x.shape[0] // (2 * n)
    g = x.reshape((n, 2, chunk) + tuple(x.shape[1:]))
    return torch.cat([g[:, 0], g[:, 1].flip(0)], 0).reshape(
        (2 * n * chunk,) + tuple(x.shape[1:]))


def _reshuffle_global(x: torch.Tensor, cp: int) -> torch.Tensor:
    """Global order -> ring device order along the leading axis (the
    exact inverse of ``_unshuffle_gathered``)."""
    n = cp
    chunk = x.shape[0] // (2 * n)
    g = x.reshape((2 * n, chunk) + tuple(x.shape[1:]))
    pairs = torch.stack([g[:n], g[n:].flip(0)], 1)
    return pairs.reshape((2 * n * chunk,) + tuple(x.shape[1:]))


# ---------------------------------------------------------------------------
# ring attention over one group
# ---------------------------------------------------------------------------
def _gather_seq(xs: Sequence[torch.Tensor], interleave: bool
                ) -> List[torch.Tensor]:
    """Every rank's (B, S_loc, ...) -> every rank's (B, n*S_loc, ...) in
    global sequence order: one ring gather over the group along the
    sequence dim, then the unshuffle.  int32 leaves travel as their bits
    (the ring moves bytes)."""
    n = len(xs)
    ints = xs[0].dtype == torch.int32
    moved = [(x.view(torch.float32) if ints else x).movedim(1, 0)
             .contiguous() for x in xs]
    out = []
    for f in kgather.odc_gather(moved):
        if interleave:
            f = _unshuffle_gathered(f, n)
        f = f.movedim(0, 1)
        out.append(f.view(torch.int32) if ints else f)
    return out


def _meta(positions, segment_ids):
    """(B, S_loc, 2) int32: a rank's positions and segment ids, gathered
    together."""
    return torch.stack([positions.to(torch.int32),
                        segment_ids.to(torch.int32)], -1)


def _local(full: torch.Tensor, n: int, interleave: bool) -> List[torch.Tensor]:
    """A (B, n*S_loc, ...) tensor in global order -> each rank's
    (B, S_loc, ...) slice in its device layout."""
    x = full.movedim(1, 0)
    if interleave:
        x = _reshuffle_global(x, n)
    return [p.movedim(0, 1).contiguous() for p in x.chunk(n, 0)]


class _RingAttention(torch.autograd.Function):
    """Forward: the ring gather of the group's keys and values and the
    chunked state sweep per rank; backward: ``flash_attention_bwd`` once
    over the group's whole sequence (see the module note)."""

    @staticmethod
    def forward(ctx, static, n, *args):
        causal, window, softcap, scale, interleave = static
        qs, ks, vs = args[:n], args[n:2 * n], args[2 * n:3 * n]
        pos, seg = args[3 * n:4 * n], args[4 * n:5 * n]
        kvs = _gather_seq([torch.stack([k, v], 2) for k, v in zip(ks, vs)],
                          interleave)
        metas = _gather_seq([_meta(p, s) for p, s in zip(pos, seg)],
                            interleave)
        S_loc = qs[0].shape[1]
        nchunks = 2 * n if interleave else n
        chunk = n * S_loc // nchunks
        outs = []
        for q, p, s, kv, meta in zip(qs, pos, seg, kvs, metas):
            carry = None
            for c in range(nchunks):  # ascending global order
                sl = slice(c * chunk, (c + 1) * chunk)
                carry = flash_attention_state(
                    q, kv[:, sl, 0], kv[:, sl, 1], carry, causal=causal,
                    window=window, logit_softcap=softcap, q_positions=p,
                    kv_positions=meta[:, sl, 0], q_segment_ids=s,
                    kv_segment_ids=meta[:, sl, 1], scale=scale)
            outs.append(finish_attention(carry, q.dtype))
        # every rank's gathered copy is the same; the backward keeps one
        ctx.save_for_backward(*qs, kvs[0], metas[0])
        ctx.n, ctx.static = n, static
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        n = ctx.n
        causal, window, softcap, scale, interleave = ctx.static
        *qs, kv, meta = ctx.saved_tensors
        qg = _gather_seq([torch.stack([q, g.to(q.dtype)], 2)
                          for q, g in zip(qs, gs)], interleave)[0]
        with record_function(BWD_LABEL):
            dq, dk, dv = flash_attention_bwd(
                qg[:, :, 0], kv[:, :, 0], kv[:, :, 1], qg[:, :, 1],
                causal=causal, window=window, logit_softcap=softcap,
                q_positions=meta[..., 0], kv_positions=meta[..., 0],
                q_segment_ids=meta[..., 1], kv_segment_ids=meta[..., 1],
                scale=scale)
        del qg
        devs = [q.device for q in qs]
        dqs, dks, dvs = ([t.to(d) for t, d in zip(_local(x, n, interleave),
                                                   devs)]
                         for x in (dq, dk, dv))
        return (None, None, *dqs, *dks, *dvs) + (None,) * (2 * n)


def _prepare(qs, ks, positions, segment_ids, scale, interleave):
    n = len(qs)
    if not (len(ks) == len(positions) == n):
        raise ValueError("one q, k, v, positions per rank of the group")
    if positions[0] is None:
        raise ValueError("ring attention needs every rank's global "
                         "positions (the batch's 'positions')")
    if segment_ids is None or segment_ids[0] is None:
        segment_ids = [torch.zeros_like(p) for p in positions]
    S_loc = qs[0].shape[1]
    if any(q.shape[1] != S_loc or k.shape[1] != S_loc
           for q, k in zip(qs, ks)):
        raise ValueError("ring attention is self-attention over equal "
                         "sequence shards")
    if interleave and S_loc % 2:
        raise ValueError(f"an interleaved shard has an even length, got "
                         f"{S_loc}")
    if scale is None:
        scale = qs[0].shape[-1] ** -0.5
    return list(segment_ids), float(scale)


def ring_attention(qs, ks, vs, positions, segment_ids=None, *,
                   causal=True, window: int = 0, logit_softcap=0.0,
                   scale=None, interleave=True) -> List[torch.Tensor]:
    """Context-parallel self-attention of one cp group.

    qs, ks, vs: each rank's (B, S_loc, H, hd) / (B, S_loc, KH, hd) shard;
    positions, segment_ids: each rank's (B, S_loc) global positions and
    segment ids (None: one segment), in the rank's device layout (the
    head+tail chunk pair with ``interleave``).  Returns each rank's
    (B, S_loc, H, hd) output.  Differentiable in q, k and v."""
    segment_ids, scale = _prepare(qs, ks, positions, segment_ids, scale,
                                  interleave)
    static = (bool(causal), int(window), float(logit_softcap), scale,
              bool(interleave))
    return list(_RingAttention.apply(static, len(qs), *qs, *ks, *vs,
                                     *positions, *segment_ids))


def allgather_attention(qs, ks, vs, positions, segment_ids=None, *,
                        causal=True, window: int = 0, logit_softcap=0.0,
                        scale=None, interleave=True) -> List[torch.Tensor]:
    """The ring's plain version, ``ring_attention``'s signature: keys,
    values, positions and segment ids concatenated over the group (the
    all-gather, whose backward sums every rank's cotangent into each
    owner's shard) and put in global order, then ``flash_attention_plain``
    of each rank's q, all under autograd."""
    segment_ids, scale = _prepare(qs, ks, positions, segment_ids, scale,
                                  interleave)
    dev = qs[0].device

    def full(xs):
        f = torch.cat([x.to(dev) for x in xs], 1)
        if interleave:
            idx = torch.from_numpy(unshuffle_indices(f.shape[1], len(xs)))
            f = f.index_select(1, idx.to(dev))
        return f

    kf, vf, pf, sf = full(ks), full(vs), full(positions), full(segment_ids)
    return [flash_attention_plain(
        q, kf.to(q.device), vf.to(q.device), causal=causal, window=window,
        logit_softcap=logit_softcap, q_positions=p,
        kv_positions=pf.to(q.device), q_segment_ids=s,
        kv_segment_ids=sf.to(q.device), scale=scale)
        for q, p, s in zip(qs, positions, segment_ids)]
