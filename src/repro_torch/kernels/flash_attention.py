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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -2.0e38
HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


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
        dq, dk, dv = flash_attention_bwd(
            q, k, v, g, causal=causal, window=window,
            logit_softcap=logit_softcap, q_positions=qp, kv_positions=kp,
            q_segment_ids=qs, kv_segment_ids=ks, scale=scale)
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
    B, S, H, hd = q.shape
    T = k.shape[1]
    if scale is None:
        scale = hd ** -0.5
    q_positions, kv_positions = _defaults(q, k, q_positions, kv_positions)
    qp = _int32(q_positions, (B, S))
    kp = _int32(kv_positions, (B, T))
    qs = None if q_segment_ids is None else _int32(q_segment_ids, (B, S))
    ks = None if kv_segment_ids is None else _int32(kv_segment_ids, (B, T))
    return _FlashAttention.apply(q, k, v, qp, kp, qs, ks, bool(causal),
                                 int(window), float(logit_softcap),
                                 float(scale))
