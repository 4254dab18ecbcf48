"""The chunk-parallel SSD scan's host-side plan, and its order written in
plain PyTorch, on the CPU.

* ``kernels.ssd_scan.launch_plan`` (the four kernels' grids, shared
  memory and workspace, as ``repro_ssd_scan_plan`` gives them on the
  card; ``chip_smoke.py`` holds the two to each other) at every shape of
  ``chip_smoke.SSD_CASES`` and at reduced mamba2's and zamba2's train and
  serve prefill shapes.  Through ``plan_block``, this file's mirror of
  the kernels' index arithmetic in ``csrc/ssd_scan.cu`` (the scores'
  triangle walk, the states' and the pass's (n, p) split, the outputs'
  reversed query tiles): every (b, h, chunk) query row and p column of y,
  every element of every chunk's state, of the state pass and every
  causal score tile of every (b, group, chunk) is computed by exactly one
  block; each block's shared memory fits an H100 block's 232,448 bytes,
  up to the largest chunk; the workspace's bytes follow the source's
  formula; and a shape the kernels refuse, the plan refuses.  The
  mirror checks the plan, not the kernels: that the kernels cover their
  outputs rests on the card tests in ``tests/test_torch_cuda.py``.
* ``ssd_scan_chunk_parallel_plain`` (the kernels' order: scores once per
  group, each chunk's own state, the sequential pass, the outputs) at
  ``tests/test_torch_ssm.py``'s four shapes plus one with a padded tail
  (dt = 0), float32 and bfloat16, against ``ssd_scan_plain`` within
  ``chip_smoke.SSD_TOL`` (1e-5 and 1e-2 of 1 + |plain|: the same f32
  algorithm with its sums in another order; bf16 y is one rounding of
  nearly equal f32 values), and against ``ssd_scan_pallas(...,
  interpret=True)`` and the JAX ``ssd_chunked`` within the reference's
  own kernel-vs-oracle tolerances, 2e-4 and 5e-2 (``tests/test_kernels.py``).

Inputs are numpy arrays from a seed, handed to both packages.  One torch
thread per test: these small tensors gain nothing from more.
"""
import importlib.util
import os
from pathlib import Path

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import ssm as jssm
from repro_torch.configs import get_reduced
from repro_torch.kernels import ssd_scan as K

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SSD_TOL = {"float32": chip_smoke.SSD_TOL[torch.float32],
           "bfloat16": chip_smoke.SSD_TOL[torch.bfloat16]}
SCAN_TOL = {"float32": 2e-4, "bfloat16": 5e-2}
# tests/test_torch_ssm.py's shapes (b, s, h, p, g, n, Q) with no padding,
# and one whose last 40 positions are a padded tail
SCAN_SHAPES = [(2, 64, 4, 16, 1, 8, 16, 0), (1, 128, 8, 32, 2, 16, 32, 0),
               (2, 96, 6, 8, 3, 4, 32, 0), (1, 64, 2, 64, 2, 64, 64, 0),
               (2, 128, 4, 16, 1, 8, 32, 40)]
# the most shared memory one H100 block may take
MAX_BLOCK_SHARED_BYTES = 232_448


def _reduced_shapes():
    """Reduced mamba2's and zamba2's scan shapes: a train batch of 2 x 128
    tokens, and a serve prefill of 4 x 40 padded to the chunk."""
    out = {}
    for arch in ("mamba2-2.7b", "zamba2-1.2b"):
        cfg = get_reduced(arch)
        Q = cfg.ssm_chunk
        for tag, b, s in (("train", 2, 128),
                          ("serve prefill", 4, -(-40 // Q) * Q)):
            out[f"reduced {arch} {tag}"] = (
                b, s, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_ngroups,
                cfg.ssm_state_size, min(Q, s))
    return out


PLAN_CASES = {**{name: case[:7] for name, case in
                 chip_smoke.SSD_CASES.items()}, **_reduced_shapes()}


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cdiv(a, b):
    return -(-a // b)


def plan_block(plan, kernel, bx, by):
    """What block (bx, by) of ``kernel`` computes, by the index arithmetic
    of its kernel in csrc/ssd_scan.cu: batch row, group or head, chunk,
    and the half-open ranges of its output (scores: query and key rows of
    the chunk; states and pass: n and p; outputs: query rows and p)."""
    b, s, h, p, g, n, Q = plan["shape"]
    T = K.TILE
    nc, npt = s // Q, _cdiv(p, T)
    if kernel == "scores":  # the lower triangle of tile pairs, row by row
        c, bg = bx % nc, bx // nc
        qi = 0
        while (qi + 1) * (qi + 2) // 2 <= by:
            qi += 1
        ti = by - qi * (qi + 1) // 2
        return {"b": bg // g, "group": bg % g, "chunk": c,
                "rows": (qi * T, min(Q, qi * T + T)),
                "cols": (ti * T, min(Q, ti * T + T))}
    if kernel == "pass":
        (tn, tp), ppt = K.PASS_TILE, _cdiv(p, K.PASS_TILE[1])
        n0, p0 = (by // ppt) * tn, (by % ppt) * tp
        return {"b": bx // h, "head": bx % h, "n": (n0, min(n, n0 + tn)),
                "p": (p0, min(p, p0 + tp))}
    if kernel == "states":
        c, bh = bx % nc, bx // nc
        n0, p0 = (by // npt) * T, (by % npt) * T
        return {"b": bh // h, "head": bh % h, "chunk": c,
                "n": (n0, min(n, n0 + T)), "p": (p0, min(p, p0 + T))}
    # outputs: the longest query tiles (the last rows) first
    bhc, p0 = bx // npt, (bx % npt) * T
    q0 = (_cdiv(Q, T) - 1 - by) * T
    return {"b": bhc // nc // h, "head": bhc // nc % h, "chunk": bhc % nc,
            "rows": (q0, min(Q, q0 + T)), "p": (p0, min(p, p0 + T))}


def _blocks(plan, kernel):
    gx, gy = plan[kernel]["grid"]
    for bx in range(gx):
        for by in range(gy):
            yield plan_block(plan, kernel, bx, by)


# ===========================================================================
# the launch plan
# ===========================================================================
@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_every_output_row_and_state_element_is_computed_once(case):
    b, s, h, p, g, n, Q = PLAN_CASES[case]
    plan = K.launch_plan(b, s, h, p, g, n, Q)
    nc = s // Q
    y = np.zeros((b, h, nc, Q, p), np.uint8)
    for blk in _blocks(plan, "outputs"):
        (r0, r1), (p0, p1) = blk["rows"], blk["p"]
        y[blk["b"], blk["head"], blk["chunk"], r0:r1, p0:p1] += 1
    assert (y == 1).all()
    states = np.zeros((b, h, nc, n, p), np.uint8)
    for blk in _blocks(plan, "states"):
        (n0, n1), (p0, p1) = blk["n"], blk["p"]
        states[blk["b"], blk["head"], blk["chunk"], n0:n1, p0:p1] += 1
    assert (states == 1).all()
    carried = np.zeros((b, h, n, p), np.uint8)
    for blk in _blocks(plan, "pass"):
        (n0, n1), (p0, p1) = blk["n"], blk["p"]
        carried[blk["b"], blk["head"], n0:n1, p0:p1] += 1
    assert (carried == 1).all()


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_scores_are_computed_once_per_group_and_causal_tile(case):
    """C.B^T once per (b, group, chunk), not per head: each (q, t) with
    t <= q by one block, and no tile above the diagonal."""
    b, s, h, p, g, n, Q = PLAN_CASES[case]
    plan = K.launch_plan(b, s, h, p, g, n, Q)
    scores = np.zeros((b, g, s // Q, Q, Q), np.uint8)
    for blk in _blocks(plan, "scores"):
        (q0, q1), (t0, t1) = blk["rows"], blk["cols"]
        assert t0 <= q0
        scores[blk["b"], blk["group"], blk["chunk"], q0:q1, t0:t1] += 1
    causal = np.tril(np.ones((Q, Q), bool))
    assert (scores[..., causal] == 1).all()
    assert (scores <= 1).all()


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_blocks_fit_the_card(case):
    b, s, h, p, g, n, Q = PLAN_CASES[case]
    for dtype in (torch.float32, torch.bfloat16):
        plan = K.launch_plan(b, s, h, p, g, n, Q, dtype)
        for k in K.KERNELS:
            gx, gy = plan[k]["grid"]
            assert 1 <= gx <= 2 ** 31 - 1 and 1 <= gy <= 65535, k
            assert plan[k]["threads"] == K.THREADS
            assert 0 <= plan[k]["smem_bytes"] <= MAX_BLOCK_SHARED_BYTES, k
        # the output step has a block for every (b, head, chunk) and query
        # tile, 64 rows each: 5,120 at mamba2's train shape against the
        # 80 blocks of a block per (b, head)
        assert (plan["outputs"]["grid"][0] * plan["outputs"]["grid"][1]
                >= b * h * (s // Q) * -(-Q // K.TILE))


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_workspace_bytes_follow_the_formula(case):
    """The formula of csrc/ssd_scan.cu's header: the score tiles (b g nc
    T(T+1)/2 tiles of 64 x 64, T = ceil(Q/64)), acum (b h s) and the
    states (b h nc n p), float32, each region a multiple of 64 floats."""
    b, s, h, p, g, n, Q = PLAN_CASES[case]
    nc, T = s // Q, -(-Q // 64)

    def up(floats):
        return -(-floats // 64) * 64

    want = 4 * (up(b * g * nc * T * (T + 1) // 2 * 64 * 64) + up(b * h * s)
                + up(b * h * nc * n * p))
    assert K.launch_plan(b, s, h, p, g, n, Q)["workspace_bytes"] == want
    assert K.workspace_bytes(b, s, h, p, g, n, Q) == want


def test_workspace_at_mamba2_train():
    """2.6 + 1.3 + 42.0 MB at mamba2's train shape, as the source says."""
    b, s, h, p, g, n, Q, _ = chip_smoke.SSD_CASES["train"]
    assert K.workspace_bytes(b, s, h, p, g, n, Q) == 4 * (
        16 * 10 * 4096 + 80 * 4096 + 80 * 16 * 128 * 64) == 45_875_200


@pytest.mark.parametrize("shape,dtype", [
    ((1, 64, 2, 129, 1, 8, 32), torch.float32),   # p above MAX_DIM
    ((1, 64, 2, 8, 1, 129, 32), torch.float32),   # n above MAX_DIM
    ((1, 64, 3, 8, 2, 8, 32), torch.float32),     # h % g
    ((1, 64, 2, 8, 1, 8, 48), torch.float32),     # s % Q
    ((1, 16640, 2, 8, 1, 8, 16640), torch.float32),  # Q above MAX_Q
    ((0, 64, 2, 8, 1, 8, 32), torch.float32),     # an empty batch
    ((1, 64, 2, 8, 1, 8, 32), torch.float16),     # a type it does not take
])
def test_plan_refuses_what_the_kernels_refuse(shape, dtype):
    with pytest.raises(ValueError):
        K.launch_plan(*shape, dtype)


def test_largest_chunk_is_set_by_shared_memory():
    """MAX_Q is the largest chunk whose acum fits both kernels that keep
    it in shared memory: at MAX_Q every block fits the card, one more
    position and the states block would not, and plan and wrapper refuse
    it with the same check."""
    Q = K.MAX_Q
    plan = K.launch_plan(1, Q, 2, 8, 1, 8, Q)
    assert max(plan[k]["smem_bytes"] for k in K.KERNELS) \
        <= MAX_BLOCK_SHARED_BYTES
    assert K._states_smem(Q + 1) > MAX_BLOCK_SHARED_BYTES
    with pytest.raises(ValueError, match="at most"):
        K._check_shape(1, Q + 1, 2, 8, 1, 8, Q + 1)


# ===========================================================================
# the kernels' order in plain PyTorch
# ===========================================================================
def _close(out, ref, tol):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    err = np.abs(out - ref)
    assert (err <= tol * (1 + np.abs(ref))).all(), float(err.max())


def _scan_inputs(b, s, h, p, g, n, pad, seed=0):
    """x, dt, A, Bm, Cm as numpy f32, distributed as ``mamba2_apply`` makes
    them (dt a softplus, A negative); the last ``pad`` positions a padded
    tail (x, B, C zero, dt 0)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)) * 0.5
    dt = np.logaddexp(rng.normal(size=(b, s, h)), 0.0)
    A = -np.exp(rng.normal(size=(h,)) * 0.3)
    Bm = rng.normal(size=(b, s, g, n)) * 0.5
    Cm = rng.normal(size=(b, s, g, n)) * 0.5
    if pad:
        for a in (x, dt, Bm, Cm):
            a[:, s - pad:] = 0
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,g,n,Q,pad", SCAN_SHAPES)
def test_chunk_parallel_order_matches_plain_pallas_and_oracle(b, s, h, p, g,
                                                              n, Q, pad,
                                                              dtype):
    j, t = _both(_scan_inputs(b, s, h, p, g, n, pad), dtype)
    y, st = K.ssd_scan_chunk_parallel_plain(*t, Q)
    assert y.dtype == t[0].dtype and st.dtype == torch.float32
    ry, rst = K.ssd_scan_plain(*t, Q)
    _close(y.float(), ry.float(), SSD_TOL[dtype])
    _close(st, rst, SSD_TOL[dtype])
    for ref in (ssd_scan_pallas(*j, chunk=Q, interpret=True),
                jssm.ssd_chunked(*j, Q)):
        _close(y.float(), np.asarray(ref[0], np.float32), SCAN_TOL[dtype])
        _close(st, ref[1], SCAN_TOL[dtype])
