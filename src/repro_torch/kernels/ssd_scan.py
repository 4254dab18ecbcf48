"""Mamba2 SSD chunked scan: the hand-written CUDA kernel, its gradient,
and its plain PyTorch version.

Counterpart of ``repro.kernels.ssd_scan.ssd_scan_pallas`` with the
contract of ``repro.kernels.ops.ssd_scan``: x ``(b, s, h, p)``, dt
``(b, s, h)``, A ``(h,)``, Bm and Cm ``(b, s, g, n)`` with ``h % g == 0``;
the chunk is ``Q = min(chunk, s)`` and ``s % Q == 0``; no initial state.
Returns y ``(b, s, h, p)`` in x's dtype and the final state
``(b, h, p, n)`` in float32.  x, Bm and Cm are float32 or bfloat16 (one
type), dt and A float32.

``ssd_scan`` runs the kernels in ``csrc/ssd_scan.cu`` on a CUDA tensor and
``ssd_scan_plain`` on a CPU tensor; there is no other route.  Either is
the forward of one ``torch.autograd.Function``, whose backward
differentiates ``models.ssm.ssd_chunked`` recomputed under autograd on the
saved inputs (the JAX package has no backward kernel either: it
differentiates its jnp scan), so a train step takes the same gradient on
both devices.

On the card a call is a chunk-parallel sequence of four kernels on one
stream (scores C.B^T once per group and chunk, each chunk's own state,
a short sequential pass over the states, the outputs) with a workspace
from PyTorch's caching allocator; ``launch_plan`` gives their grids,
shared memory and workspace, and ``ssd_scan_chunk_parallel_plain`` is
their order written in PyTorch.  ``launches`` counts calls that ran the
sequence: one per call, whatever the number of kernels in it.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's limit on the head dim p and the state size n
MAX_DIM = 128
#: the profiler label of the backward on the card's path
BWD_LABEL = "ssd_scan.bwd"

launches = 0

# The sequence's tiles (csrc/ssd_scan.cu): threads of every block, rows
# and columns of an output tile, depth of a staged operand tile, floats
# of a [row][k] tile (row stride depth + 4) and of a [k][column] one;
# workspace regions start on multiples of ALIGN floats.
THREADS = 128
TILE = 64
K_STEP = 32
TILE_RK = TILE * (K_STEP + 4)
TILE_KC = K_STEP * TILE
PASS_TILE = (8, 32)  # the state pass: (n, p) tiles
ALIGN = 64
KERNELS = ("scores", "states", "pass", "outputs")
#: the most shared memory an H100 block may take (227 KB)
MAX_BLOCK_SMEM = 232_448


def _states_smem(Q: int) -> int:
    """Shared memory of a states block: its tiles, the chunk's acum and
    decays (3Q floats) and a double a warp for the scan."""
    return 4 * (4 * TILE_KC + 3 * Q) + 8 * (THREADS // 32)


def _outputs_smem(Q: int) -> int:
    """Shared memory of an outputs block: its tiles and 2Q floats."""
    return 4 * (2 * TILE_RK + 2 * TILE_KC + 2 * Q)


#: the largest chunk: both kernels that keep the chunk's acum in shared
#: memory fit a block (16,637 positions, set by the states kernel)
MAX_Q = min((MAX_BLOCK_SMEM - _states_smem(0)) // 12,
            (MAX_BLOCK_SMEM - _outputs_smem(0)) // 8)


def _chunk(x, Bm, chunk: int) -> int:
    """Q of the contract, after checking the shapes of x and Bm."""
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"want x (b,s,h,p) and Bm (b,s,g,n), got "
                         f"{tuple(x.shape)}, {tuple(Bm.shape)}")
    b, s, h, _ = x.shape
    if Bm.shape[:2] != (b, s) or h % Bm.shape[2]:
        raise ValueError(f"Bm {tuple(Bm.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    Q = min(int(chunk), s)
    if Q < 1 or s % Q:
        raise ValueError(f"seq {s} not divisible by chunk {Q}")
    return Q


def decay_cumsum(x, dim):
    """Cumulative sum of an f32 tensor, accumulated in f64 and rounded to
    f32 once per position: on every device the rounding a CPU cumsum of
    f32 has (it accumulates in f64), and what the kernel computes.  The
    chunk's decays are exp() of differences of these sums, |sum| up to
    ~180 at mamba2's chunk of 256, so an f32 running sum (or a parallel
    f32 scan, as a CUDA cumsum is) costs them about 1e-4 relative."""
    return torch.cumsum(x.double(), dim=dim).float()


def ssd_scan_plain(x, dt, A, Bm, Cm, chunk: int):
    """The kernel's function in the Pallas kernel's own order
    (``_ssd_kernel``): per (b, h) -- every (b, h) at once -- chunk after
    chunk, the (p, n) state carried from one chunk to the next, all in
    float32."""
    b, s, h, p = x.shape
    rep = h // Bm.shape[2]
    Q = _chunk(x, Bm, chunk)
    f32 = torch.float32
    xf = x.to(f32).permute(0, 2, 1, 3)                      # (b, h, s, p)
    dtf = dt.to(f32).permute(0, 2, 1)                       # (b, h, s)
    Bh = Bm.to(f32).repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    Ch = Cm.to(f32).repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    a = A.to(f32)[None, :, None]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    state = torch.zeros((b, h, p, Bm.shape[3]), dtype=f32, device=x.device)
    ys = []
    for c in range(s // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xc, dtc, bmat, cmat = xf[:, :, sl], dtf[:, :, sl], Bh[:, :, sl], \
            Ch[:, :, sl]
        xd = xc * dtc[..., None]
        acum = decay_cumsum(a * dtc, -1)                    # (b, h, Q)
        # intra-chunk: exp(acum_q - acum_t) where q >= t, selected before
        # the exponential
        diff = acum[..., :, None] - acum[..., None, :]
        lmat = torch.exp(torch.where(tri, diff, float("-inf")))
        scores = cmat @ bmat.transpose(-1, -2)              # (b, h, Q, Q)
        y = (scores * lmat) @ xd
        # off-diagonal: the state entering this chunk
        y = y + torch.exp(acum)[..., None] * (cmat @ state.transpose(-1, -2))
        decay_end = torch.exp(acum[..., -1:] - acum)
        state = (state * torch.exp(acum[..., -1])[..., None, None]
                 + (xd * decay_end[..., None]).transpose(-1, -2) @ bmat)
        ys.append(y)
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)
    return y.to(x.dtype).contiguous(), state


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def workspace_bytes(b, s, h, p, g, n, Q) -> int:
    """Bytes of the call's float32 workspace: the score tiles (b g nc
    T(T+1)/2 tiles of 64 x 64, T = ceil(Q / 64)), acum (b h s) and the
    chunks' states (b h nc n p), each region rounded up to ALIGN floats."""
    nc, T = s // Q, _cdiv(Q, TILE)
    regions = (b * g * nc * T * (T + 1) // 2 * TILE * TILE, b * h * s,
               b * h * nc * n * p)
    return 4 * sum(_cdiv(r, ALIGN) * ALIGN for r in regions)


def _check_shape(b, s, h, p, g, n, Q) -> None:
    """Raises ValueError for a shape the kernels refuse."""
    if min(b, s, h, g, Q, p, n) < 1 or h % g or s % Q:
        raise ValueError(f"(b, s, h, p, g, n, Q) = {(b, s, h, p, g, n, Q)}: "
                         f"want positive sizes, h % g == 0, s % Q == 0")
    if p > MAX_DIM or n > MAX_DIM or Q > MAX_Q:
        raise ValueError(f"head dim {p} and state size {n} must be at most "
                         f"{MAX_DIM}, the chunk {Q} at most {MAX_Q}")
    blocks = b * h * (s // Q) * _cdiv(p, TILE)
    if blocks > 2 ** 31 - 1:
        raise ValueError(f"{blocks} blocks exceed the grid")


def launch_plan(b, s, h, p, g, n, Q, dtype=torch.float32) -> dict:
    """The launches of one call on the card, as ``repro_ssd_scan_plan``
    gives them: for each kernel of ``KERNELS`` its grid (x, y), threads
    and shared memory bytes of a block; and the workspace's bytes.
    Raises ValueError for a shape or type the kernels refuse."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"ssd_scan takes float32 or bfloat16, not {dtype}")
    _check_shape(b, s, h, p, g, n, Q)
    nc, npt = s // Q, _cdiv(p, TILE)
    T = _cdiv(Q, TILE)
    grids = {"scores": (b * g * nc, T * (T + 1) // 2),
             "states": (b * h * nc, _cdiv(n, TILE) * npt),
             "pass": (b * h, _cdiv(n, PASS_TILE[0]) * _cdiv(p, PASS_TILE[1])),
             "outputs": (b * h * nc * npt, T)}
    smem = {"scores": 4 * 4 * TILE_RK, "states": _states_smem(Q),
            "pass": 4 * PASS_TILE[0] * (PASS_TILE[1] + 1),
            "outputs": _outputs_smem(Q)}
    return {"shape": (b, s, h, p, g, n, Q),
            **{k: {"grid": grids[k], "threads": THREADS,
                   "smem_bytes": smem[k]} for k in KERNELS},
            "workspace_bytes": workspace_bytes(b, s, h, p, g, n, Q)}


def ssd_scan_chunk_parallel_plain(x, dt, A, Bm, Cm, chunk: int):
    """The kernels' order in plain PyTorch, float32: the scores C.B^T once
    per (b, group, chunk); per (b, h, chunk) acum and the chunk's own
    state; the sequential pass, ``state * exp(acum_end) + S_c``, which
    yields the state entering each chunk; then every chunk's outputs at
    once, ``exp(acum_q) (C_q . entering) + (G * L) xd``."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    Q = _chunk(x, Bm, chunk)
    nc = s // Q
    f32 = torch.float32
    # (b, heads or groups, chunk, position, width)
    xh = x.to(f32).reshape(b, nc, Q, h, p).permute(0, 3, 1, 2, 4)
    dth = dt.to(f32).reshape(b, nc, Q, h).permute(0, 3, 1, 2)
    Bg = Bm.to(f32).reshape(b, nc, Q, g, n).permute(0, 3, 1, 2, 4)
    Cg = Cm.to(f32).reshape(b, nc, Q, g, n).permute(0, 3, 1, 2, 4)
    G = Cg @ Bg.transpose(-1, -2)                        # (b, g, nc, Q, Q)
    acum = decay_cumsum(A.to(f32)[None, :, None, None] * dth, -1)
    xd = xh * dth[..., None]
    decay_end = torch.exp(acum[..., -1:] - acum)
    Bh = Bg.repeat_interleave(rep, dim=1)
    S = (xd * decay_end[..., None]).transpose(-1, -2) @ Bh  # (b, h, nc, p, n)
    state = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = (state * torch.exp(acum[:, :, c, -1])[..., None, None]
                 + S[:, :, c])
    ent = torch.stack(entering, dim=2)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    lmat = torch.exp(torch.where(
        tri, acum[..., :, None] - acum[..., None, :], float("-inf")))
    Ch = Cg.repeat_interleave(rep, dim=1)
    y = (torch.exp(acum)[..., None] * (Ch @ ent.transpose(-1, -2))
         + (G.repeat_interleave(rep, dim=1) * lmat) @ xd)
    y = y.permute(0, 2, 3, 1, 4).reshape(b, s, h, p)
    return y.to(x.dtype).contiguous(), state


def _check_cuda(x, dt, A, Bm, Cm):
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if x.dtype not in _DTYPE_CODES or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise TypeError(f"x, Bm, Cm must share one of float32/bfloat16, got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}, "
                        f"{A.dtype}")
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) \
            or tuple(Cm.shape) != tuple(Bm.shape):
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, Cm "
                         f"{tuple(Cm.shape)} do not fit x {tuple(x.shape)} "
                         f"and Bm {tuple(Bm.shape)}")
    if p > MAX_DIM or n > MAX_DIM:
        raise ValueError(f"head dim {p} and state size {n} must be at most "
                         f"{MAX_DIM}")
    for t in (dt, A, Bm, Cm):
        if t.device != x.device:
            raise ValueError("x, dt, A, Bm, Cm must lie on one device")


def _launch(x, dt, A, Bm, Cm, Q):
    """One run of the kernel sequence on contiguous inputs, its workspace
    from the caching allocator (freed when the call returns, after the
    kernels on the stream that use it)."""
    global launches
    for t in (x, dt, A, Bm, Cm):
        if not t.is_contiguous():
            raise ValueError("ssd_scan's kernel takes contiguous tensors")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    _check_shape(b, s, h, p, g, n, Q)
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    ws = torch.empty(workspace_bytes(b, s, h, p, g, n, Q), dtype=torch.uint8,
                     device=x.device)
    fn = _build.library("ssd_scan").repro_ssd_scan
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), y.data_ptr(), state.data_ptr(), ws.data_ptr(),
                 ws.numel(), b, s, h, p, g, n, Q, _DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel failed to launch: CUDA error "
                           f"{err}")
    launches += 1
    return y, state


class _SSDScan(torch.autograd.Function):
    """The CUDA kernel (a CUDA tensor) or the plain version (a CPU tensor)
    as forward; the backward differentiates ``ssd_chunked`` recomputed on
    the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, Q):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.Q = Q
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            return ssd_scan_plain(x, dt, A, Bm, Cm, Q)
        return _launch(x, dt, A, Bm, Cm, Q)

    @staticmethod
    def backward(ctx, gy, gstate):
        from repro_torch.models.ssm import ssd_chunked

        need = ctx.needs_input_grad[:5]
        if not any(need):
            return (None,) * 6
        ins = [t.detach().requires_grad_(r)
               for t, r in zip(ctx.saved_tensors, need)]
        with torch.enable_grad(), record_function(BWD_LABEL):
            y, state = ssd_chunked(*ins, ctx.Q)
            pairs = [(o, g) for o, g in ((y, gy), (state, gstate))
                     if g is not None]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], [t for t in ins if t.requires_grad],
                [g for _, g in pairs], allow_unused=True))
        return (*(next(got) if r else None for r in need), None)


def ssd_scan(x, dt, A, Bm, Cm, chunk: int):
    """The SSD scan: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor, each differentiable through ``ssd_chunked``.
    Returns (y, final_state)."""
    Q = _chunk(x, Bm, chunk)
    if x.device.type == "cpu":
        return _SSDScan.apply(x, dt, A, Bm, Cm, Q)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    _check_cuda(x, dt, A, Bm, Cm)
    return _SSDScan.apply(x.contiguous(), dt.contiguous(), A.contiguous(),
                          Bm.contiguous(), Cm.contiguous(), Q)
