"""Flash attention: the hand-written CUDA forward kernel, its backward, and
its plain PyTorch version.

Counterpart of ``repro.kernels.flash_attention.flash_attention_pallas``,
with its signature and layout: q ``(B, S, H, hd)``, k/v ``(B, T, KH, hd)``
with ``H % KH == 0`` (q head h reads kv head ``h // (H // KH)``), int32
positions and segment ids, output ``(B, S, H, hd)`` in q's dtype.  Negative
kv positions mark padding.

``flash_attention`` runs the kernel in ``csrc/flash_attention.cu`` on a
CUDA tensor and ``flash_attention_plain`` on a CPU tensor; there is no
other route.  ``launches`` counts kernel launches.  On a CUDA tensor the
call is a ``torch.autograd.Function``: the kernel is its forward, and its
backward is ``flash_attention_bwd``, a port of the JAX package's
``flash_attention_bwd_ref`` (the VJP of ``flash_attention_diff``; the JAX
package has no backward kernel either).  On a CPU tensor autograd
differentiates the plain version.

A row whose every key is masked has no defined answer: both versions then
average V over whatever they padded to, as the TPU kernel does over its
block-padded length.  No serving row is fully masked (prefill sees
position 0, decode sees its own slot), and the comparisons in the tests
hold only rows with at least one valid key.

``flash_attention_state`` is the counterpart of
``repro.kernels.flash_attention.flash_attention_state``, the ring
attention's building block: one online-softmax sweep of q over a kv
*chunk*, with the softmax state ``(m, l, acc)`` (m, l ``(B, S, H)``, acc
``(B, S, H, hd)``, float32) entering as a carry and leaving unnormalized;
``fresh_carry`` is the state before the first chunk and
``finish_attention`` normalizes.  On a CUDA tensor it launches the same
kernel's state instantiation, which updates the carry in place;
``flash_attention_state_plain`` is its plain version, which CPU tensors
take.  ``state_launches`` counts its launches.

The kernel has two paths behind one entry point, chosen by the C side
from the shapes: a (batch, kv head) with at most ``decode_rows(hd)``
flattened query rows (S x G) takes the decode path, which splits the
keys over a cluster of ``decode_split(KH)`` blocks; more rows take the tiled
loop, which the state sweep always takes.  ``launch_plan`` reports the
path and launch shape a call gets, and ``flash_decode_split_plain``
repeats the decode path's split and merge in plain PyTorch (for the
tests and the chip smoke test; the wrapper never calls it).
"""
from __future__ import annotations

import ctypes

import torch
from torch.profiler import record_function

from repro_torch.kernels import _build

NEG_INF = -2.0e38
HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: keys of a tile of the decode path (``csrc/flash_attention.cu``)
DECODE_TILE = 64

launches = 0
state_launches = 0
#: the profiler label of the backward (``flash_attention_bwd``) on the
#: card's path, so that a trace can attribute its kernels
BWD_LABEL = "flash_attention.bwd"


def _defaults(q, k, q_positions, kv_positions):
    B, S = q.shape[:2]
    T = k.shape[1]
    if q_positions is None:
        q_positions = torch.arange(S, device=q.device).expand(B, S)
    if kv_positions is None:
        kv_positions = torch.arange(T, device=q.device).expand(B, T)
    return q_positions, kv_positions


def attn_mask(q_positions, kv_positions, q_segment_ids, kv_segment_ids, *,
              causal, window):
    """(B, S, T) boolean mask: the predicate the kernel applies per tile
    (``repro.kernels.flash_attention._attn_mask``)."""
    rel = q_positions[:, :, None] - kv_positions[:, None, :]
    mask = (kv_positions >= 0)[:, None, :].expand(rel.shape)
    if causal:
        mask = mask & (rel >= 0)
    if window > 0:
        mask = mask & (rel < window)
    if q_segment_ids is not None or kv_segment_ids is not None:
        qs = (q_segment_ids if q_segment_ids is not None
              else torch.zeros_like(q_positions))
        ks = (kv_segment_ids if kv_segment_ids is not None
              else torch.zeros_like(kv_positions))
        mask = mask & (qs[:, :, None] == ks[:, None, :])
    return mask


def flash_attention_plain(q, k, v, *, causal=True, window=0,
                          logit_softcap=0.0, q_positions=None,
                          kv_positions=None, q_segment_ids=None,
                          kv_segment_ids=None, scale=None):
    """The kernel's function computed directly: masked, soft-capped
    softmax attention over the materialized (B, KH, G, S, T) scores, in
    f32."""
    B, S, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    if scale is None:
        scale = hd ** -0.5
    q_positions, kv_positions = _defaults(q, k, q_positions, kv_positions)
    qg = q.float().reshape(B, S, KH, G, hd) * scale
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    mask = attn_mask(q_positions, kv_positions, q_segment_ids,
                     kv_segment_ids, causal=causal, window=window)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    out = acc / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, S, H, hd).to(q.dtype)


def _check(q, k, v, *tensors):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,S,H,hd), k = v (B,T,KH,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of float32/bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    for t in (q, k, v):
        if t.device != q.device or t.stride(-1) != 1:
            raise ValueError("q, k, v must lie on one device with a "
                             "contiguous head dim")
    for t in tensors:
        if t is not None and t.device != q.device:
            raise ValueError("positions and segment ids must lie on q's "
                             "device")


def decode_rows(hd):
    """The most flattened query rows (S x G) of a (batch, kv head) that
    take the decode path (``decode_rows`` in ``csrc/flash_attention.cu``):
    16, or 8 at head dim 256."""
    return 8 if hd == 256 else 16


def decode_split(kv_heads):
    """Blocks of a decode cluster (``decode_split`` in
    ``csrc/flash_attention.cu``): 8, halved while the clusters of one
    batch row would hold more than 64 blocks; tile t goes to block
    t % decode_split(KH)."""
    n = 8
    while n > 1 and n * kv_heads > 64:
        n //= 2
    return n


_PLAN_KEYS = ("decode", "grid_x", "grid_y", "grid_z", "threads",
              "smem_bytes", "cluster", "rows_tile", "keys_tile")


def launch_plan(B, S, T, H, KH, hd, dtype=torch.float32, state=False):
    """The launch a kernel call of these shapes gets, launching nothing:
    its path (``decode`` True or False), grid, threads, dynamic shared
    memory bytes, cluster size and tile (rows: BQ or the decode
    instantiation's row bound; keys).  Builds the kernel library."""
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    err = _build.library("flash_attention").repro_flash_attention_plan(
        B, S, T, H, KH, hd, _DTYPE_CODES[dtype], int(bool(state)), out)
    if err != 0:
        raise ValueError(f"no flash_attention launch for B={B} S={S} T={T} "
                         f"H={H} KH={KH} hd={hd} {dtype}: CUDA error {err}")
    plan = dict(zip(_PLAN_KEYS, out))
    plan["decode"] = bool(plan["decode"])
    return plan


def _rows16(t):
    """t, or a contiguous copy of it when one of its K/V rows would not
    start on 16 bytes: the kernel reads rows in 16-byte pieces.  Every
    main-path call passes its k and v as they are."""
    vec = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and all(s % vec == 0 for s in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _int32(t, shape):
    if tuple(t.shape) != shape:
        raise ValueError(f"want shape {shape}, got {tuple(t.shape)}")
    return t.to(torch.int32).contiguous()


def flash_attention_bwd(q, k, v, g, *, causal=True, window=0,
                        logit_softcap=0.0, q_positions=None,
                        kv_positions=None, q_segment_ids=None,
                        kv_segment_ids=None, scale=None):
    """(dq, dk, dv) of the attention at cotangent ``g``: recompute the
    masked, soft-capped probabilities and apply the closed-form softmax
    VJP, with dk and dv summed over each GQA group
    (``repro.kernels.flash_attention.flash_attention_bwd_ref``).
    Materializes the (B, H, S, T) scores in f32."""
    B, S, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    if scale is None:
        scale = hd ** -0.5
    q_positions, kv_positions = _defaults(q, k, q_positions, kv_positions)
    qf = q.float()
    kq = k.float().repeat_interleave(G, dim=2)  # (B, T, H, hd)
    vq = v.float().repeat_interleave(G, dim=2)
    gf = g.float()

    s = torch.einsum("bshd,bthd->bhst", qf * scale, kq)
    t = None
    if logit_softcap > 0.0:
        t = torch.tanh(s / logit_softcap)
        s = logit_softcap * t
    mask = attn_mask(q_positions, kv_positions, q_segment_ids,
                     kv_segment_ids, causal=causal, window=window)
    s = torch.where(mask[:, None], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    del s
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    pn = p / l[..., None]
    del p

    dv_q = torch.einsum("bhst,bshd->bthd", pn, gf)
    dp = torch.einsum("bshd,bthd->bhst", gf, vq)
    delta = (pn * dp).sum(dim=-1)
    ds = pn * (dp - delta[..., None])
    del pn, dp
    if t is not None:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bhst,bthd->bshd", ds, kq) * scale
    dk_q = torch.einsum("bhst,bshd->bthd", ds, qf) * scale
    dk = dk_q.reshape(B, T, KH, G, hd).sum(3)
    dv = dv_q.reshape(B, T, KH, G, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _mask_args(q, k, q_positions, kv_positions, q_segment_ids,
               kv_segment_ids):
    """Positions and segment ids as the kernel takes them: int32,
    contiguous, of the shapes of q and k."""
    B, S = q.shape[:2]
    T = k.shape[1]
    q_positions, kv_positions = _defaults(q, k, q_positions, kv_positions)
    qp = _int32(q_positions, (B, S))
    kp = _int32(kv_positions, (B, T))
    qs = None if q_segment_ids is None else _int32(q_segment_ids, (B, S))
    ks = None if kv_segment_ids is None else _int32(kv_segment_ids, (B, T))
    return qp, kp, qs, ks


def _launch(q, k, v, qp, kp, qs, ks, causal, window, logit_softcap, scale):
    """One launch of the forward kernel; qp/kp/qs/ks already int32."""
    global launches
    B, S, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    fn = _build.library("flash_attention").repro_flash_attention_fwd
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             qp.data_ptr(), kp.data_ptr(),
             None if qs is None else qs.data_ptr(),
             None if ks is None else ks.data_ptr(),
             B, S, T, H, KH, hd, _DTYPE_CODES[q.dtype],
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3],
             int(bool(causal)), int(window), float(logit_softcap),
             float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel failed to launch: CUDA "
                           f"error {err}")
    launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """The CUDA kernel as forward, ``flash_attention_bwd`` as backward
    (``_flash_diff`` with its custom VJP in the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, qp, kp, qs, ks, causal, window, logit_softcap,
                scale):
        ctx.save_for_backward(q, k, v, qp, kp, qs, ks)
        ctx.static = (causal, window, logit_softcap, scale)
        return _launch(q, k, v, qp, kp, qs, ks, causal, window,
                       logit_softcap, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, qp, kp, qs, ks = ctx.saved_tensors
        causal, window, logit_softcap, scale = ctx.static
        with record_function(BWD_LABEL):
            dq, dk, dv = flash_attention_bwd(
                q, k, v, g, causal=causal, window=window,
                logit_softcap=logit_softcap, q_positions=qp,
                kv_positions=kp, q_segment_ids=qs, kv_segment_ids=ks,
                scale=scale)
        return (dq, dk, dv) + (None,) * 8


def flash_attention(q, k, v, *, causal=True, window=0, logit_softcap=0.0,
                    q_positions=None, kv_positions=None, q_segment_ids=None,
                    kv_segment_ids=None, scale=None):
    """Attention: the CUDA kernel (differentiable through
    ``flash_attention_bwd``) for a CUDA tensor, the plain version for a
    CPU tensor.  ``window`` must be a Python int."""
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, window=window,
            logit_softcap=logit_softcap, q_positions=q_positions,
            kv_positions=kv_positions, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check(q, k, v, q_positions, kv_positions, q_segment_ids,
           kv_segment_ids)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qp, kp, qs, ks = _mask_args(q, k, q_positions, kv_positions,
                                q_segment_ids, kv_segment_ids)
    k, v = _rows16(k), _rows16(v)
    return _FlashAttention.apply(q, k, v, qp, kp, qs, ks, bool(causal),
                                 int(window), float(logit_softcap),
                                 float(scale))


# ---------------------------------------------------------------------------
# the state sweep: one chunk of a ring attention
# ---------------------------------------------------------------------------
def fresh_carry(B, S, H, hd, device="cpu"):
    """The softmax state before the first kv tile: exactly what the
    monolithic kernel starts each row from, so a sweep started here is
    bitwise that kernel's."""
    return (torch.full((B, S, H), NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((B, S, H), dtype=torch.float32, device=device),
            torch.zeros((B, S, H, hd), dtype=torch.float32, device=device))


def finish_attention(carry, dtype=torch.float32):
    """Normalize a carried (m, l, acc): ``acc / max(l, 1e-30)`` rounded to
    ``dtype``, the same operations as the kernel's final step, so the
    result is bitwise what the kernel would have written."""
    _, l, acc = carry
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(dtype)


def flash_attention_state_plain(q, k, v, carry=None, *, causal=True,
                                window=0, logit_softcap=0.0,
                                q_positions=None, kv_positions=None,
                                q_segment_ids=None, kv_segment_ids=None,
                                scale=None):
    """The state sweep computed directly: the chunk's masked, soft-capped
    scores materialized in f32 and folded into the carry as one online-
    softmax step.  Returns new (m, l, acc); the carry is not modified."""
    B, S, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    if scale is None:
        scale = hd ** -0.5
    if carry is None:
        carry = fresh_carry(B, S, H, hd, q.device)
    q_positions, kv_positions = _defaults(q, k, q_positions, kv_positions)
    m0 = carry[0].reshape(B, S, KH, G)
    l0 = carry[1].reshape(B, S, KH, G)
    acc0 = carry[2].reshape(B, S, KH, G, hd)
    qg = q.float().reshape(B, S, KH, G, hd) * scale
    s = torch.einsum("bskgd,btkd->bskgt", qg, k.float())
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    mask = attn_mask(q_positions, kv_positions, q_segment_ids,
                     kv_segment_ids, causal=causal, window=window)
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    m = torch.maximum(m0, s.amax(dim=-1))
    p = torch.exp(s - m[..., None])
    corr = torch.exp(m0 - m)
    l = l0 * corr + p.sum(dim=-1)
    acc = acc0 * corr[..., None] + torch.einsum("bskgt,btkd->bskgd", p,
                                                v.float())
    return m.reshape(B, S, H), l.reshape(B, S, H), acc.reshape(B, S, H, hd)


def _check_carry(carry, q):
    B, S, H, hd = q.shape
    for t, shape in zip(carry, ((B, S, H), (B, S, H), (B, S, H, hd))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"carry must be contiguous float32 (m, l, acc) "
                             f"of shapes (B,S,H), (B,S,H), (B,S,H,hd) on "
                             f"q's device; got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")


def flash_attention_state(q, k, v, carry=None, *, causal=True, window=0,
                          logit_softcap=0.0, q_positions=None,
                          kv_positions=None, q_segment_ids=None,
                          kv_segment_ids=None, scale=None):
    """One online-softmax sweep of q ``(B, S, H, hd)`` over a kv chunk
    ``(B, T, KH, hd)``, carrying ``(m, l, acc)`` (None: ``fresh_carry``).
    The carry is updated in place and returned: by the CUDA kernel for a
    CUDA tensor, from ``flash_attention_state_plain`` for a CPU tensor.
    Finish with ``finish_attention``.  Not differentiable (the ring
    attention's backward is its own, ``core.cp``).  ``window`` must be a
    Python int."""
    global state_launches
    B, S, H, hd = q.shape
    if carry is None:
        carry = fresh_carry(B, S, H, hd, q.device)
    _check_carry(carry, q)
    kw = dict(causal=causal, window=window, logit_softcap=logit_softcap,
              q_positions=q_positions, kv_positions=kv_positions,
              q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
              scale=scale)
    if q.device.type == "cpu":
        for dst, src in zip(carry, flash_attention_state_plain(
                q, k, v, carry, **kw)):
            dst.copy_(src)
        return carry
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_state runs on cuda or cpu, not "
                         f"{q.device}")
    _check(q, k, v, q_positions, kv_positions, q_segment_ids,
           kv_segment_ids)
    if scale is None:
        scale = hd ** -0.5
    qp, kp, qs, ks = _mask_args(q, k, q_positions, kv_positions,
                                q_segment_ids, kv_segment_ids)
    T, KH = k.shape[1], k.shape[2]
    k, v = _rows16(k), _rows16(v)
    m, l, acc = carry
    fn = _build.library("flash_attention").repro_flash_attention_state
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
             l.data_ptr(), acc.data_ptr(), qp.data_ptr(), kp.data_ptr(),
             None if qs is None else qs.data_ptr(),
             None if ks is None else ks.data_ptr(),
             B, S, T, H, KH, hd, _DTYPE_CODES[q.dtype],
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             int(bool(causal)), int(window), float(logit_softcap),
             float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_state kernel failed to launch: "
                           f"CUDA error {err}")
    state_launches += 1
    return carry


# ---------------------------------------------------------------------------
# the decode path's algorithm, in plain PyTorch
# ---------------------------------------------------------------------------
def flash_decode_split_plain(q, k, v, *, causal=True, window=0,
                             logit_softcap=0.0, q_positions=None,
                             kv_positions=None, q_segment_ids=None,
                             kv_segment_ids=None, scale=None):
    """The decode kernel's split and merge: the keys cut into tiles of
    ``DECODE_TILE``, tile t to split ``t % decode_split(KH)``; each split's
    partial (m, l, acc) from ``flash_attention_state_plain`` on a fresh
    carry, or the fresh carry itself, (NEG_INF, 0, 0), where no (row, key)
    pair of a batch row's split is valid (the kernel skips such a split);
    the partials merged in split order as the cluster's rank 0 merges
    them, ``acc / max(l, 1e-30)``.  Used by the tests and the chip smoke
    test, never by the wrapper."""
    B, S, H, hd = q.shape
    T, nsplit = k.shape[1], decode_split(k.shape[2])
    q_positions, kv_positions = _defaults(q, k, q_positions, kv_positions)
    tile = torch.arange(T, device=k.device) // DECODE_TILE
    parts = []
    for x in range(nsplit):
        carry = fresh_carry(B, S, H, hd, q.device)
        idx = torch.nonzero(tile % nsplit == x).flatten()
        if idx.numel():
            ks = (None if kv_segment_ids is None
                  else kv_segment_ids.index_select(1, idx))
            kp = kv_positions.index_select(1, idx)
            mine = flash_attention_state_plain(
                q, k.index_select(1, idx), v.index_select(1, idx),
                causal=causal, window=window, logit_softcap=logit_softcap,
                q_positions=q_positions, kv_positions=kp,
                q_segment_ids=q_segment_ids, kv_segment_ids=ks, scale=scale)
            live = attn_mask(q_positions, kp, q_segment_ids, ks,
                             causal=causal, window=window).flatten(1).any(1)
            carry = tuple(torch.where(live.view(B, *[1] * (a.dim() - 1)), a,
                                      f) for a, f in zip(mine, carry))
        parts.append(carry)
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    A = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        f = torch.exp(m - M)
        L = L + l * f
        A = A + acc * f[..., None]
    return (A / torch.clamp(L, min=1e-30)[..., None]).to(q.dtype)
