"""Mamba2 (SSD, state-space duality) block: the PyTorch counterpart of
``repro.models.ssm``, with the same parameter names and layouts.

The train forward and prefill run the chunked SSD scan through one hook,
``set_ssd_impl``.  Its default is the hand-written kernel's wrapper,
``kernels.ssd_scan.ssd_scan``: the CUDA kernel on a CUDA tensor, its plain
version on a CPU tensor.  ``ssd_chunked`` is the algorithmic reference (a
port of the JAX package's jnp scan, with an initial state), which the
tests and the chip smoke test swap in for the plain route.  The decode
step, ``ssd_recurrent_step``, is plain PyTorch, as the JAX package
computes it outside any kernel.

One deliberate difference from the reference: ``ssd_chunked`` selects the
intra-chunk decay ``exp(Acum_q - Acum_t)`` only where q >= t, before the
exponential.  The JAX scan exponentiates the whole (Q, Q) block and then
masks; for q < t the exponent is positive and overflows once a chunk's
decay passes e^88 (mamba2-2.7b's chunk of 256 does so at init), and its
gradient then holds 0 * inf = NaN in dt and A.  The forward values are
the same.  The chunk's cumulative decay is summed in f64 and rounded to
f32 once (``kernels.ssd_scan.decay_cumsum``, as a CPU cumsum of f32 does
on its own), on every device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import decay_cumsum, ssd_scan
from repro_torch.models.layers import dense_init, promoted_matmul, rms_norm

_SSD_IMPL = ssd_scan


def set_ssd_impl(fn):
    """Install ``fn(x, dt, A, Bm, Cm, chunk) -> (y, final_state)``
    (``ssd_chunked``'s contract without an initial state) as the scan of
    ``mamba2_apply``; ``None`` restores the kernel.  Returns the impl it
    displaced, for the caller to restore."""
    global _SSD_IMPL
    prev = _SSD_IMPL
    _SSD_IMPL = ssd_scan if fn is None else fn
    return prev


def mamba2_params(gen: torch.Generator, cfg, dtype, prefix_shape=()):
    d = cfg.d_model
    di, nh, ng, ss = (cfg.ssm_d_inner, cfg.ssm_nheads, cfg.ssm_ngroups,
                      cfg.ssm_state_size)
    conv_dim = di + 2 * ng * ss
    in_dim = 2 * di + 2 * ng * ss + nh  # z, x, B, C, dt
    full = lambda shape, v: torch.full(prefix_shape + shape, v, dtype=dtype,
                                       device=gen.device)
    return {
        "in_proj": dense_init(gen, prefix_shape + (d, in_dim), dtype),
        "conv_w": dense_init(gen, prefix_shape + (cfg.ssm_conv_width,
                                                  conv_dim), dtype),
        "conv_b": full((conv_dim,), 0.0),
        "dt_bias": full((nh,), 0.0),
        "A_log": full((nh,), 0.0),
        "D": full((nh,), 1.0),
        "gate_norm": full((di,), 0.0),
        "out_proj": dense_init(gen, prefix_shape + (di, d), dtype,
                               scale=1.0 / max(1, cfg.num_layers) ** 0.5),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv.  x: (B, S, C); w: (W, C)."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = xp[:, 0:S, :] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S, :] * w[i]
    return F.silu(out + b)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """Chunked SSD scan.

    x: (b, s, h, p); dt: (b, s, h); A: (h,) < 0; Bm, Cm: (b, s, g, n) with
    h % g == 0.  Returns (y (b, s, h, p) in x's dtype, final_state
    (b, h, p, n) float32)."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    Q = min(chunk, s)
    if s % Q:
        raise ValueError(f"seq {s} not divisible by chunk {Q}")
    Nc = s // Q
    f32 = torch.float32

    xd = (x * dt[..., None]).to(f32).reshape(b, Nc, Q, h, p)
    Adt = (A * dt).to(f32).reshape(b, Nc, Q, h)
    Bh = Bm.to(f32).reshape(b, Nc, Q, g, n).repeat_interleave(rep, dim=3)
    Ch = Cm.to(f32).reshape(b, Nc, Q, g, n).repeat_interleave(rep, dim=3)

    Acum = decay_cumsum(Adt, 2)  # (b, Nc, Q, h), summed in f64

    # intra-chunk (diagonal blocks): L[q, t] = exp(Acum[q] - Acum[t]) for
    # q >= t, else 0; selected before the exponential (see the module doc)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    diff = Acum[:, :, :, None, :] - Acum[:, :, None, :, :]  # (b,Nc,Q,Q,h)
    Lmat = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                                 float("-inf")))
    scores = torch.einsum("bcqhn,bcthn->bcqth", Ch, Bh)
    y_diag = torch.einsum("bcqth,bcthp->bcqhp", scores * Lmat, xd)

    # chunk states
    decay_to_end = torch.exp(Acum[:, :, -1:, :] - Acum)  # (b, Nc, Q, h)
    states = torch.einsum("bcqhn,bcqhp->bchpn",
                          Bh * decay_to_end[..., None], xd)

    # inter-chunk recurrence
    chunk_decay = torch.exp(Acum[:, :, -1, :])  # (b, Nc, h)
    carry = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    priors = []
    for c in range(Nc):
        priors.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    priors = torch.stack(priors, dim=1)  # (b, Nc, h, p, n): entering each

    y_off = torch.einsum("bcqhn,bchpn->bcqhp",
                         Ch * torch.exp(Acum)[..., None], priors)
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), carry


def ssd_recurrent_step(x_t, dt_t, A, B_t, C_t, state):
    """One decode step.  x_t: (b, h, p); dt_t: (b, h); B_t, C_t: (b, g, n);
    state: (b, h, p, n)."""
    h = x_t.shape[1]
    rep = h // B_t.shape[1]
    f32 = torch.float32
    Bh = B_t.repeat_interleave(rep, dim=1).to(f32)  # (b, h, n)
    Ch = C_t.repeat_interleave(rep, dim=1).to(f32)
    dA = torch.exp((A * dt_t).to(f32))  # (b, h)
    xd = (x_t * dt_t[..., None]).to(f32)
    state = state * dA[:, :, None, None] + torch.einsum("bhn,bhp->bhpn", Bh,
                                                        xd)
    y = torch.einsum("bhn,bhpn->bhp", Ch, state)
    return y.to(x_t.dtype), state


def mamba2_apply(cfg, p, x, *, cache=None):
    """Mamba2 mixer.  x: (B, S, d).  cache: None (the train forward), or a
    dict with 'conv' (B, W-1, conv_dim) and 'ssm' (B, h, p, n): S > 1
    prefills into a fresh cache (its contents are not read), S == 1 is one
    decode step.  Returns (out, new cache); the cache passed in is not
    written."""
    B, S, _ = x.shape
    di, nh, ng, ss = (cfg.ssm_d_inner, cfg.ssm_nheads, cfg.ssm_ngroups,
                      cfg.ssm_state_size)
    hd = cfg.ssm_head_dim
    conv_dim = di + 2 * ng * ss
    W = cfg.ssm_conv_width
    f32 = torch.float32

    zxbcdt = promoted_matmul(x, p["in_proj"])
    z, xbc, dt = torch.split(zxbcdt, [di, conv_dim, nh], dim=-1)
    dt = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))
    A = -torch.exp(p["A_log"].to(f32))
    D = p["D"].to(f32)

    if cache is None or S > 1:
        # training forward, or prefill-from-scratch into a fresh cache
        conv_out = _causal_conv(xbc, p["conv_w"], p["conv_b"])
        # pad the sequence to a chunk multiple (padded steps have dt = 0,
        # a no-op on the state)
        Q = min(cfg.ssm_chunk, max(1, S))
        pad = (-S) % Q
        dt_p = dt
        if pad:
            conv_out = F.pad(conv_out, (0, 0, 0, pad))
            dt_p = F.pad(dt, (0, 0, 0, pad))
        Sp = S + pad
        xs, Bm, Cm = torch.split(conv_out, [di, ng * ss, ng * ss], dim=-1)
        xs = xs.reshape(B, Sp, nh, hd)
        Bm = Bm.reshape(B, Sp, ng, ss)
        Cm = Cm.reshape(B, Sp, ng, ss)
        y, final_state = _SSD_IMPL(xs, dt_p, A, Bm, Cm, Q)
        y = (y + xs * D[None, None, :, None])[:, :S]
        new_cache = None
        if cache is not None:
            W1 = W - 1
            tail = F.pad(xbc, (0, 0, max(0, W1 - S), 0))[:, -W1:]
            new_cache = {"conv": tail.to(cache["conv"].dtype),
                         "ssm": final_state}
    else:
        if S != 1:
            raise ValueError(f"decode expects a single new token, got {S}")
        t = torch.promote_types(cache["conv"].dtype, xbc.dtype)
        window = torch.cat([cache["conv"].to(t), xbc.to(t)], dim=1)
        conv_out = F.silu(torch.einsum("bwc,wc->bc", window,
                                       p["conv_w"].to(t))
                          + p["conv_b"])[:, None, :]
        xs, Bm, Cm = torch.split(conv_out, [di, ng * ss, ng * ss], dim=-1)
        xs1 = xs.reshape(B, nh, hd)
        y1, ssm_state = ssd_recurrent_step(
            xs1, dt[:, 0], A, Bm.reshape(B, ng, ss), Cm.reshape(B, ng, ss),
            cache["ssm"])
        y = (y1 + xs1 * D[None, :, None])[:, None]
        new_cache = {"conv": window[:, 1:], "ssm": ssm_state}

    y = y.reshape(B, S, di) * F.silu(z)
    y = rms_norm(y, p["gate_norm"], cfg.norm_eps)
    return promoted_matmul(y, p["out_proj"]), new_cache


def init_ssm_cache(cfg, batch: int, dtype=torch.float32, device="cuda"):
    di, ng, ss = cfg.ssm_d_inner, cfg.ssm_ngroups, cfg.ssm_state_size
    conv_dim = di + 2 * ng * ss
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_head_dim, ss),
                           dtype=torch.float32, device=device),
    }
