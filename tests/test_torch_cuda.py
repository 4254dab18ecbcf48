"""Card tests of the port: the CUDA flash-attention kernel against its
plain version, its gradient, its launch counter and its input checks, its
two paths at the decode threshold, the decode path against its split
algorithm and bitwise the same for a row in any batch, and the state sweep
bitwise the monolithic kernel over chunks of 64, 128 and 256 keys; the
ODC ring kernels and their chained-layer versions against the plain rings
(the broadcast gathers and the pull scatter: any grid, sources off 16
bytes, NaN bit patterns, and no allocation but their outputs; the chained
rings and the q8 scatter: their refusal of a grid that cannot be
co-resident); the state sweep
kernel against its plain version, and the cp ring over it against the
monolithic kernel (bitwise) and against its plain route (gradient); a
reduced serve run and reduced train steps (ODC x minibatch, collective x
layer, ODC under the overlap schedule, cp) on the card against the same
run on the CPU; the Mamba2 SSD scan kernel against its plain version
(forward, gradient, the chunk-parallel sequence's edges, one launch
counted per call), and reduced mamba2 serve and train runs on the
card against the CPU; the gather_matmul kernel on each of its routes
(tensor cores, CUDA cores; route counters) against its plain version
(f32 within 1e-5 of max |plain|, bf16 within 1e-2), each hop kept to
its own shard's columns of x, and its refusals; and
reduced zamba2 (5 layers: a tail, two invocations of the shared block)
serve and train runs on the card against the CPU; and reduced grok-1 (the
moe family) prefill and decode on the flash kernel against the plain
attention route under the routing rule, and one ODC x minibatch step
against collective x layer; the flash kernel at seamless-m4t-medium's
encoder and cross-attention shapes, and reduced seamless (the audio
family) prefill and decode on the kernel against the plain attention
route, and one ODC x minibatch step against collective x layer; a reduced
GRPO step through the post-training driver on the kernel route against
the plain route, an ODC weight push bitwise the trainer's parameters with
one row-1 launch a sharded leaf, and continuous runs with live pushes
under collective (a barrier that stalls the slots) and odc (none).  Each
test needs an NVIDIA GPU and skips without one.

This file imports no jax, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jax.)  Tolerance on rows
with at least one valid key, |diff| <= TOL * (1 + |plain|): float32 1e-5
(sum order), bfloat16 1e-2 (one bf16 rounding step of the output).  The
flash gradient, kernel route against plain route, 1e-4 in f32 (the
backward's T-term sums in another order).  The rings: bitwise (they move
data, and the scatter adds in the plain ring's hop order).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, B, S, T, H, KH, hd, *, last=None, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((B, S, H, hd), (B, T, KH, hd), (B, T, KH, hd)))
    qp = (T - S + torch.arange(S, device=dev)).expand(B, S)
    kp = torch.arange(T, device=dev).expand(B, T)
    if last is not None:
        last = torch.as_tensor(last, device=dev)
        qp = last[:, None].expand(B, S)
        kp = torch.where(kp <= last[:, None], kp, -(10 ** 9))
    return q, k, v, dict(q_positions=qp.int(), kv_positions=kp.int())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,KH,hd,kw", [
    (2, 130, 130, 12, 2, 128, {}),
    (3, 1, 97, 12, 2, 128, {"last": [0, 40, 96]}),
    (1, 45, 70, 4, 2, 64, {"window": 16}),
    (2, 64, 64, 4, 2, 256, {"logit_softcap": 50.0, "window": 24}),
    (2, 33, 33, 4, 1, 32, {"causal": False}),
])
def test_kernel_matches_plain(cuda, dtype, B, S, T, H, KH, hd, kw):
    kw = dict(kw)
    q, k, v, pos = _inputs(cuda, dtype, B, S, T, H, KH, hd,
                           last=kw.pop("last", None))
    kw.update(pos)
    before = fa.launches
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, **kw)
    rows = fa.attn_mask(pos["q_positions"], pos["kv_positions"], None, None,
                        causal=kw.get("causal", True),
                        window=kw.get("window", 0)).any(-1)
    o, r = out.float()[rows], ref.float()[rows]
    assert out.dtype == dtype and torch.isfinite(o).all()
    assert ((o - r).abs() <= TOL[dtype] * (1 + r.abs())).all()


def test_kernel_refuses_before_launch(cuda):
    q, k, v, pos = _inputs(cuda, torch.float32, 1, 4, 4, 2, 1, 48)
    before = fa.launches
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, k, v)
    q, k, v, pos = _inputs(cuda, torch.float32, 1, 4, 4, 2, 1, 32)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.bfloat16(), v)
    assert fa.launches == before


def _close_on_valid_rows(out, ref, kw, dtype):
    rows = fa.attn_mask(kw["q_positions"], kw["kv_positions"],
                        kw.get("q_segment_ids"), kw.get("kv_segment_ids"),
                        causal=kw.get("causal", True),
                        window=kw.get("window", 0)).any(-1)
    o, r = out.float()[rows], ref.float()[rows]
    return bool(torch.isfinite(o).all()) and bool(
        ((o - r).abs() <= TOL[dtype] * (1 + r.abs())).all())


@pytest.mark.parametrize("extra", [0, 1])
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paths_at_the_decode_threshold(cuda, dtype, hd, extra):
    """rows = S x G at the decode path's threshold take the decode path,
    one more row the tiled loop; both agree with the plain version and
    launch once."""
    rows = fa.decode_rows(hd) + extra
    S, G = (rows, 1) if extra else (rows // 2, 2)
    B, T, KH = 3, 300, 2
    q, k, v, pos = _inputs(cuda, dtype, B, S, T, G * KH, KH, hd,
                           last=[40, 299, 170])
    pos["q_positions"] = pos["q_positions"] - S + 1 + torch.arange(
        S, device=cuda, dtype=torch.int32)
    plan = fa.launch_plan(B, S, T, G * KH, KH, hd, dtype)
    assert plan["decode"] == (extra == 0)
    assert plan["cluster"] == (fa.decode_split(KH) if extra == 0 else 1)
    before = fa.launches
    out = fa.flash_attention(q, k, v, **pos)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, **pos)
    assert _close_on_valid_rows(out, ref, pos, dtype)


@pytest.mark.parametrize("S", [1, 40])
def test_kernel_takes_kv_rows_off_16_bytes(cuda, S):
    """k and v whose rows do not start on 16 bytes (a row stride of 129
    floats) are copied by the wrapper, then run by either path."""
    q, k, v, pos = _inputs(cuda, torch.float32, 2, S, 90, 4, 2, 128,
                           last=[89, 50])
    wide = [torch.zeros(2, 90, 2, 129, device=cuda) for _ in range(2)]
    for w, x in zip(wide, (k, v)):
        w[..., :128] = x
    ko, vo = (w[..., :128] for w in wide)
    out = fa.flash_attention(q, ko, vo, **pos)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q, k, v, **pos)
    assert _close_on_valid_rows(out, ref, pos, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [{}, {"window": 96}, {"logit_softcap": 30.0},
                                {"segments": True}])
def test_decode_kernel_matches_split_plain(cuda, dtype, kw):
    """The decode path at qwen's decode shape (12/2 heads, hd 128) against
    ``flash_decode_split_plain`` (its algorithm) and the plain version."""
    kw = dict(kw)
    q, k, v, pos = _inputs(cuda, dtype, 4, 1, 700, 12, 2, 128,
                           last=[699, 64, 300, 5], seed=3)
    if kw.pop("segments", False):
        ks = (torch.arange(700, device=cuda)[None] >= 50).int().expand(4, 700)
        pos.update(q_segment_ids=torch.ones(4, 1, dtype=torch.int32,
                                            device=cuda),
                   kv_segment_ids=ks.contiguous())
    kw.update(pos)
    assert fa.launch_plan(4, 1, 700, 12, 2, 128, dtype)["decode"]
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    for ref in (fa.flash_decode_split_plain(q, k, v, **kw),
                fa.flash_attention_plain(q, k, v, **kw)):
        assert _close_on_valid_rows(out, ref, kw, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KH,hd", [(12, 2, 128), (32, 32, 64)])
def test_decode_row_is_the_same_in_any_batch(cuda, dtype, H, KH, hd):
    """The decode split depends on neither the batch size nor the other
    rows: each row of a batch of 8 equals the same row run alone, bit for
    bit (8 splits at 2 kv heads, 2 at 32); the batch agrees with the
    split algorithm."""
    last = [543, 527, 3, 64, 300, 511, 128, 400]
    q, k, v, pos = _inputs(cuda, dtype, 8, 1, 544, H, KH, hd, last=last,
                           seed=4)
    out = fa.flash_attention(q, k, v, **pos)
    assert _close_on_valid_rows(
        out, fa.flash_decode_split_plain(q, k, v, **pos), pos, dtype)
    for b in range(8):
        one = fa.flash_attention(
            q[b:b + 1], k[b:b + 1], v[b:b + 1],
            q_positions=pos["q_positions"][b:b + 1],
            kv_positions=pos["kv_positions"][b:b + 1])
        assert torch.equal(one, out[b:b + 1])


def test_reduced_serve_on_card_matches_cpu(cuda):
    """Reduced qwen prefill on the card (kernel) against the CPU (plain),
    same weights: last-position logits within 1e-4 (the projections and
    MLP products also run on other hardware, in another order)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.posttrain.engine import GenerationEngine

    cfg = get_reduced("qwen-1.5b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(1, cfg.vocab_size, (4, 40),
                           generator=torch.Generator().manual_seed(1))
    logits = {}
    for dev in ("cpu", "cuda"):
        eng = GenerationEngine(cfg, device=dev)
        p = _to(params, dev)
        out, _ = eng.prefill(p, eng.prompt_batch(tokens),
                             eng.init_cache(4, 48))
        logits[dev] = out.cpu()
    err = (logits["cuda"] - logits["cpu"]).abs()
    assert (err <= 1e-4 * (1 + logits["cpu"].abs())).all(), float(err.max())


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.mark.parametrize("B,S,T,H,KH,hd,kw", [
    (2, 130, 130, 12, 2, 128, {}),
    (3, 1, 97, 12, 2, 128, {"last": [0, 40, 96]}),
    (1, 45, 70, 4, 2, 64, {"window": 16}),
    (2, 64, 64, 4, 2, 256, {"logit_softcap": 50.0, "window": 24}),
    (2, 33, 33, 4, 1, 32, {"causal": False}),
])
def test_kernel_gradient_matches_plain(cuda, B, S, T, H, KH, hd, kw):
    """dq, dk and dv through the kernel (autograd Function, ported
    backward) against autograd through the plain version."""
    kw = dict(kw)
    q, k, v, pos = _inputs(cuda, torch.float32, B, S, T, H, KH, hd,
                           last=kw.pop("last", None), seed=3)
    kw.update(pos)
    g = torch.randn(q.shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(4))
    grads = {}
    for name, fn in (("kernel", fa.flash_attention),
                     ("plain", fa.flash_attention_plain)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        fn(*leaves, **kw).backward(g)
        grads[name] = [x.grad for x in leaves]
    for a, b in zip(grads["kernel"], grads["plain"]):
        assert a is not None and torch.isfinite(a).all()
        assert ((a - b).abs() <= 1e-4 * (1 + b.abs())).all(), \
            float((a - b).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 3, 4, 8, 16])
@pytest.mark.parametrize("ordered", [False, True])
def test_ring_kernels_match_plain_rings(cuda, dtype, n, ordered):
    """Both single-leaf kernels bitwise against the plain rings; shards of
    (c, 3) and an odd 1-D c, whose chunks start off 16 bytes (the pull
    scatter's scalar head and tail)."""
    from repro_torch.kernels import odc_gather as G
    from repro_torch.kernels import odc_scatter as S

    order = list(reversed(range(n))) if ordered else None
    gen = torch.Generator(device=cuda).manual_seed(n)
    for shape in ((1, 3), (1000, 3), (4099, 3), (1001,)):
        c = shape[0]
        xs = [torch.randn(shape, generator=gen, device=cuda).to(dtype)
              for _ in range(n)]
        before = G.launches
        out = G.odc_gather(xs, order)
        torch.cuda.synchronize()
        assert G.launches == before + 1
        ref = G.odc_gather_plain(xs, order)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
        ys = [torch.randn((n * c,) + shape[1:], generator=gen,
                          device=cuda).to(dtype) for _ in range(n)]
        before = S.launches
        out = S.odc_scatter_accumulate(ys, order)
        torch.cuda.synchronize()
        assert S.launches == before + 1
        ref = S.odc_scatter_accumulate_plain(ys, order)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))


def _nan_bits(n, c, cuda):
    """n ranks' (c,) int32 leaves of NaN and infinity bit patterns and
    counts, as float32 views: the cp path's segment ids travel so."""
    pats = torch.tensor([0x7FC00001, 0x7F800001, -1, 0x7F800000, 3,
                         -0x00400001], dtype=torch.int32)
    return [(pats.repeat(c // len(pats) + 1)[:c] + r).to(cuda)
            .view(torch.float32) for r in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_takes_any_grid(cuda, dtype):
    """No block of the broadcast gather waits for another, so any grid
    runs, a million blocks a rank included, and gives the same bits; so
    does a source that is a view at storage offset 1 (off 16 bytes) and a
    payload of NaN bit patterns.  A grid outside [1, 2**31), a bad ring
    order, a dtype or a layout the kernel does not take are refused before
    launch."""
    from repro_torch.kernels import odc_gather as G

    n, order = 3, [1, 2, 0]
    gen = torch.Generator(device=cuda).manual_seed(7)
    xs = [torch.randn(5003, generator=gen, device=cuda).to(dtype)
          for _ in range(n)]
    ref = G.odc_gather_plain(xs, order)
    for grid in (1, 7, None, 1 << 20):
        out = G.odc_gather(xs, order, blocks_per_rank=grid)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, ref)), grid
    views = [torch.randn(5004, generator=gen, device=cuda).to(dtype)[1:]
             for _ in range(n)]
    assert all(v.data_ptr() % 16 and v.is_contiguous() for v in views)
    for grid in (1, 7, None):
        out = G.odc_gather(views, blocks_per_rank=grid)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in
                   zip(out, G.odc_gather_plain(views))), grid
    bits = _nan_bits(n, 1001, cuda)
    out = G.odc_gather(bits, order)
    torch.cuda.synchronize()
    want = torch.cat([b.view(torch.int32) for b in bits])
    assert all(torch.equal(o.view(torch.int32), want) for o in out)
    before = G.launches
    with pytest.raises(ValueError, match="blocks_per_rank"):
        G.odc_gather(xs, blocks_per_rank=0)
    with pytest.raises(ValueError, match="permutation"):
        G.odc_gather(xs, [0, 0, 1])
    with pytest.raises(TypeError):
        G.odc_gather([x.half() for x in xs])
    with pytest.raises(ValueError, match="contiguous"):
        G.odc_gather([torch.ones(8, 2, device=cuda).t() for _ in range(2)])
    assert G.launches == before


def test_gathers_allocate_only_their_outputs(cuda):
    """The broadcast gathers (f32 and q8 codes) allocate their outputs and
    nothing else: no staging in device memory, no flag state."""
    from repro_torch.kernels import odc_gather as G
    from repro_torch.kernels import quant as Q

    n, c, nc = 4, 1 << 18, 1 << 10
    xs = [torch.randn(c, device=cuda) for _ in range(n)]
    qs = [torch.randint(-127, 128, (nc, 256), dtype=torch.int8,
                        device=cuda) for _ in range(n)]
    ss = [torch.rand(nc, 1, device=cuda) for _ in range(n)]
    for fn, args in ((G.odc_gather, (xs,)), (Q.gather_codes, (qs, ss))):
        fn(*args)  # built and loaded before counting
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
        out = fn(*args)
        torch.cuda.synchronize()
        outs = out if fn is G.odc_gather else out[0] + out[1]
        nbytes = sum(o.numel() * o.element_size() for o in outs)
        assert torch.cuda.memory_allocated(cuda) - before == nbytes
        assert torch.cuda.max_memory_allocated(cuda) - before == nbytes
        del out, outs


def test_scatter_allocates_only_its_outputs(cuda):
    """The pull scatter allocates its outputs and nothing else: no staging
    in device memory, no flag state."""
    from repro_torch.kernels import odc_scatter as S

    n, c = 4, 1 << 18
    ys = [torch.randn(n * c, device=cuda) for _ in range(n)]
    S.odc_scatter_accumulate(ys)  # built and loaded before counting
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    like = [torch.empty(c, device=cuda) for _ in range(n)]
    outputs = torch.cuda.memory_allocated(cuda) - before
    del like
    torch.cuda.reset_peak_memory_stats(cuda)
    out = S.odc_scatter_accumulate(ys)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda) - before == outputs
    assert torch.cuda.max_memory_allocated(cuda) - before == outputs
    ref = S.odc_scatter_accumulate_plain(ys)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_takes_any_grid(cuda, dtype):
    """No block of the pull scatter waits for another, so any grid runs,
    a million blocks a rank included, and gives the same bits; a grid
    outside [1, 2**31) is refused before launch."""
    from repro_torch.kernels import odc_scatter as S

    n, order = 3, [1, 2, 0]
    gen = torch.Generator(device=cuda).manual_seed(7)
    ys = [torch.randn(n * 5003, generator=gen, device=cuda).to(dtype)
          for _ in range(n)]
    ref = S.odc_scatter_accumulate_plain(ys, order)
    for grid in (1, 3, None, 1 << 20):
        out = S.odc_scatter_accumulate(ys, order, blocks_per_rank=grid)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, ref)), grid
    before = S.launches
    with pytest.raises(ValueError, match="blocks_per_rank"):
        S.odc_scatter_accumulate(ys, blocks_per_rank=0)
    assert S.launches == before


def _chain_edges(kind, dtype, n):
    """Layer sizes (elements) at the chained kernel's tile edges on n
    ranks: a slice shorter than one tile, exactly three tiles, three tiles
    and one element, and an odd count (rows not 16-byte aligned: the
    threads' copy route)."""
    from repro_torch.kernels import _ring

    es = torch.empty(0, dtype=dtype).element_size()
    te = _ring.chain_layout(kind, n).tile_bytes // es
    return (te - 1, 3 * te, 3 * te + 1, 1001)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,L", [(2, 3), (4, 28), (8, 28), (16, 3)])
def test_chained_ring_kernels_match_plain_rings(cuda, dtype, n, L):
    """Both chained kernels, the scatter also in backward layer order and
    accumulating, bitwise against the plain rings; 28 layers on 4 and 8
    ranks are 84 and 196 hops in one launch, and a second launch follows
    each first.  Layers of (c, 3), then of c elements at the tile edges of
    each kernel (``_chain_edges``).  16 ranks need a cluster of 16 blocks
    (non-portable): a card that cannot hold one refuses it clearly."""
    from repro_torch.kernels import odc_gather as G
    from repro_torch.kernels import odc_scatter as S

    order = list(reversed(range(n)))
    gen = torch.Generator(device=cuda).manual_seed(n + L)
    if n == 16:
        try:
            G.odc_gather_layers([torch.ones(L, 8, device=cuda)] * n)
        except RuntimeError as e:
            assert "cannot hold one cluster" in str(e)
            return
    # (1003, 3) also cut into three clusters of ragged slices
    cases = [((1, 3), None), ((1003, 3), None), ((1003, 3), 3)]
    cases += [((c,), None) for c in sorted(set(
        _chain_edges("gather", dtype, n) + _chain_edges("scatter", dtype, n)))]
    for shape, grid in cases:
        c = shape[0]
        xs = [torch.randn((L,) + shape, generator=gen, device=cuda).to(dtype)
              for _ in range(n)]
        for o in (None, order):
            before = G.layers_launches
            out = G.odc_gather_layers(xs, o, blocks_per_rank=grid)
            torch.cuda.synchronize()
            assert G.layers_launches == before + 1
            ref = G.odc_gather_layers_plain(xs, o)
            assert all(torch.equal(a, b) for a, b in zip(out, ref))
        ys = [torch.randn((L, n * c) + shape[1:], generator=gen,
                          device=cuda).to(dtype) for _ in range(n)]
        for o in (None, order):
            out = S.odc_scatter_accumulate_layers(ys, o, blocks_per_rank=grid)
            torch.cuda.synchronize()
            ref = S.odc_scatter_accumulate_layers_plain(ys, o)
            assert all(torch.equal(a, b) for a, b in zip(out, ref))
            acc = [torch.ones_like(r) for r in ref]
            S.odc_scatter_accumulate_layers(ys, o, reverse=True, out=acc,
                                            blocks_per_rank=grid)
            torch.cuda.synchronize()
            assert all(torch.equal(a, 1 + b) for a, b in zip(acc, ref))


def test_chained_rings_refuse_a_grid_that_cannot_be_resident(cuda):
    from repro_torch.kernels import odc_gather as G
    from repro_torch.kernels import odc_scatter as S

    xs = [torch.ones(2, 64, device=cuda) for _ in range(2)]
    ys = [torch.ones(2, 128, device=cuda) for _ in range(2)]
    for fn, args in ((G.odc_gather_layers, xs),
                     (S.odc_scatter_accumulate_layers, ys)):
        before = (G.layers_launches, S.layers_launches)
        with pytest.raises(RuntimeError, match="resident"):
            fn(args, blocks_per_rank=1 << 20)
        assert (G.layers_launches, S.layers_launches) == before
    out = G.odc_gather_layers(xs)
    torch.cuda.synchronize()
    assert all(torch.equal(o, torch.ones(2, 128, device=cuda)) for o in out)


def test_chained_launches_allocate_only_their_outputs(cuda):
    """A chained launch allocates its outputs and nothing else (no staging
    in device memory): none with ``out=``, as much as the outputs without."""
    from repro_torch.kernels import odc_gather as G
    from repro_torch.kernels import odc_scatter as S

    n, L, c = 2, 4, 50_000
    xs = [torch.randn(L, c, device=cuda) for _ in range(n)]
    ys = [torch.randn(L, n * c, device=cuda) for _ in range(n)]
    full = [torch.empty(L, n * c, device=cuda) for _ in range(n)]
    acc = [torch.zeros(L, c, device=cuda) for _ in range(n)]
    G.odc_gather_layers(xs, out=full)  # built and loaded before counting
    S.odc_scatter_accumulate_layers(ys, out=acc)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    G.odc_gather_layers(xs, out=full)
    S.odc_scatter_accumulate_layers(ys, out=acc)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda) == before
    like = [torch.empty(L, n * c, device=cuda) for _ in range(n)]
    outputs = torch.cuda.memory_allocated(cuda) - before
    del like
    out = G.odc_gather_layers(xs)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda) - before == outputs
    assert all(torch.equal(a, b) for a, b in zip(out, full))


@pytest.mark.parametrize("comm,schedule", [("odc", "minibatch"),
                                           ("collective", "layer"),
                                           ("odc-overlap", "overlap")])
def test_reduced_train_step_on_card_matches_cpu(cuda, comm, schedule):
    """Two reduced train steps with two ranks on the card (flash and ring
    kernels) against the same steps on the CPU (plain versions), same
    weights and batches: losses within 1e-5 relative (f32 products and
    sums on other hardware in another order)."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.ranks import RankGroup
    from repro_torch.core.train_step import Trainer
    from repro_torch.data.loader import SyntheticSFTLoader
    from repro_torch.data.packing import build_minibatch
    from repro_torch.kernels import odc_gather as G
    from repro_torch.models import transformer as T

    launched = "layers_launches" if schedule == "overlap" else "launches"
    cfg = get_reduced("qwen-1.5b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    loader = SyntheticSFTLoader("longalign", vocab_size=cfg.vocab_size,
                                world_size=2, minibatch_per_device=2,
                                max_tokens=128, max_len=120, seed=0)
    steps = list(loader.steps(2))
    losses = {}
    for dev in ("cpu", "cuda"):
        tr = Trainer(cfg, RankGroup.make(2, dev), comm=comm,
                     schedule=schedule)
        shards, opt = tr.init_state(_to(params, dev))
        before = getattr(G, launched)
        losses[dev] = []
        for sd in steps:
            batch = build_minibatch(sd["plan"], sd["sample_tokens"], 128)
            counts = [len(a) for a in sd["plan"].assignments]
            shards, opt, m = tr.step(shards, opt, batch, counts)
            losses[dev].append(float(m["loss"]))
        if dev == "cuda" and comm != "collective":
            assert getattr(G, launched) > before
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-5 * abs(b), (losses["cuda"], losses["cpu"])


# ---------------------------------------------------------------------------
# the state sweep kernel and the cp ring over it
# ---------------------------------------------------------------------------
def _packed(dev, dtype, B, S, H, KH, hd, seed=0):
    """Global q, k, v of a packed row: two segments and a padding tail
    (positions -1e9), as the train path's rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd)))
    pad, cut = S // 8, (S - S // 8) // 2
    pos = torch.full((B, S), -(10 ** 9), dtype=torch.int32, device=dev)
    seg = torch.full((B, S), -1, dtype=torch.int32, device=dev)
    pos[:, :cut] = torch.arange(cut, device=dev, dtype=torch.int32)
    pos[:, cut:S - pad] = torch.arange(S - pad - cut, device=dev,
                                       dtype=torch.int32)
    seg[:, :cut], seg[:, cut:S - pad] = 0, 1
    return q, k, v, pos, seg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunks,H,KH,hd,window", [
    (1, 12, 2, 128, 0), (3, 4, 4, 64, 96), (4, 12, 2, 128, 96)])
def test_state_kernel_matches_plain(cuda, dtype, chunks, H, KH, hd, window):
    """The state sweep over ``chunks`` chunks (ragged: 90 keys each, no
    multiple of the kv tile) from a fresh carry: the carry after each
    chunk and the finished output against the plain version, on rows with
    a valid key so far."""
    q, k, v, pos, seg = _packed(cuda, dtype, 2, 90 * chunks, H, KH, hd)
    kw = dict(causal=True, window=window, q_positions=pos,
              q_segment_ids=seg)
    carry, ref = None, None
    before = fa.state_launches
    for c in range(chunks):
        sl = slice(c * 90, (c + 1) * 90)
        ck = dict(kw, kv_positions=pos[:, sl], kv_segment_ids=seg[:, sl])
        carry = fa.flash_attention_state(q, k[:, sl], v[:, sl], carry, **ck)
        torch.cuda.synchronize()
        ref = fa.flash_attention_state_plain(q, k[:, sl], v[:, sl], ref,
                                             **ck)
        rows = fa.attn_mask(pos, pos[:, :(c + 1) * 90], seg,
                            seg[:, :(c + 1) * 90], causal=True,
                            window=window).any(-1)
        for a, b in zip(carry, ref):
            a, b = a[rows], b[rows]
            assert torch.isfinite(a).all()
            assert ((a - b).abs() <= TOL[torch.float32] * (1 + b.abs())).all()
    assert fa.state_launches == before + chunks
    out, want = fa.finish_attention(carry, dtype), fa.finish_attention(ref,
                                                                       dtype)
    o, r = out.float()[rows], want.float()[rows]
    assert ((o - r).abs() <= TOL[dtype] * (1 + r.abs())).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,interleave", [(2, True), (2, False), (4, True)])
def test_ring_forward_is_bitwise_the_monolithic_kernel(cuda, dtype, n,
                                                       interleave):
    """The cp ring's forward (ring gather kernel, state-kernel sweep in
    ascending global order, chunks of 64 keys: a multiple of every kv
    tile) equals the monolithic kernel on the gathered sequence, bit for
    bit, on rows with a valid key."""
    from repro_torch.core import cp

    S = 2 * n * 64
    q, k, v, pos, seg = _packed(cuda, dtype, 1, S, 12, 2, 128, seed=5)
    perm = torch.from_numpy(cp.interleave_indices(S, n) if interleave
                            else np.arange(S)).to(cuda)
    split = lambda x: list(x.index_select(1, perm).chunk(n, 1))
    outs = cp.ring_attention(split(q), split(k), split(v), split(pos),
                             split(seg), interleave=interleave)
    out = torch.empty_like(q)
    out[:, perm] = torch.cat(outs, 1)
    ref = fa.flash_attention(q, k, v, q_positions=pos, kv_positions=pos,
                             q_segment_ids=seg, kv_segment_ids=seg)
    torch.cuda.synchronize()
    rows = fa.attn_mask(pos, pos, seg, seg, causal=True, window=0).any(-1)
    assert torch.equal(out[rows], ref[rows])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("chunk", [64, 128, 256])
def test_state_sweep_is_bitwise_the_monolithic_kernel(cuda, dtype, hd, chunk):
    """The state kernel swept over chunks of 64, 128 or 256 keys from a
    fresh carry (one launch a chunk), finished, equals the monolithic
    kernel on the whole row bit for bit on rows with a valid key: the
    chunks are multiples of every kv tile, and both run one tile loop."""
    S = 768
    q, k, v, pos, seg = _packed(cuda, dtype, 2, S, 8, 2, hd, seed=6)
    kw = dict(q_positions=pos, q_segment_ids=seg)
    carry = None
    before = fa.state_launches
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        carry = fa.flash_attention_state(
            q, k[:, sl], v[:, sl], carry, kv_positions=pos[:, sl],
            kv_segment_ids=seg[:, sl], **kw)
    assert fa.state_launches == before + S // chunk
    ref = fa.flash_attention(q, k, v, kv_positions=pos, kv_segment_ids=seg,
                             **kw)
    out = fa.finish_attention(carry, dtype)
    torch.cuda.synchronize()
    rows = fa.attn_mask(pos, pos, seg, seg, causal=True, window=0).any(-1)
    assert torch.equal(out[rows], ref[rows])


def test_ring_gradient_matches_plain_route(cuda):
    """dq, dk, dv of the ring's group Function against autograd through
    ``allgather_attention``, 2 ranks, on rows with a valid key;
    |diff| <= 1e-4 * (1 + |plain|), as the flash gradient above
    (float32, the same closed form against autograd, sums in another
    order)."""
    from repro_torch.core import cp

    n, S = 2, 512
    q, k, v, pos, seg = _packed(cuda, torch.float32, 1, S, 12, 2, 128, seed=6)
    perm = torch.from_numpy(cp.interleave_indices(S, n)).to(cuda)
    split = lambda x: list(x.index_select(1, perm).chunk(n, 1))
    # rows without a valid key (the padding tail) have no defined answer,
    # and the two routes differentiate them differently: cotangent 0
    rows = fa.attn_mask(pos, pos, seg, seg, causal=True, window=0).any(-1)
    g = split(torch.randn(q.shape, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(7)) * rows[:, :, None, None])
    grads = {}
    for name, fn in (("ring", cp.ring_attention),
                     ("plain", cp.allgather_attention)):
        leaves = [[t.clone().requires_grad_(True) for t in split(x)]
                  for x in (q, k, v)]
        outs = fn(*leaves, split(pos), split(seg))
        torch.autograd.backward(outs, g)
        grads[name] = [t.grad for ts in leaves for t in ts]
    for a, b in zip(grads["ring"], grads["plain"]):
        assert torch.isfinite(a).all()
        assert ((a - b).abs() <= 1e-4 * (1 + b.abs())).all(), \
            float((a - b).abs().max())


def test_reduced_cp_train_steps_on_card_match_cpu(cuda):
    """Two reduced cp train steps (data 1 x cp 2, lb_token) on the card
    (ring gather and state kernels) against the CPU (plain versions):
    losses within 1e-5 relative, as the other train steps above."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.ranks import RankGroup
    from repro_torch.core.train_step import Trainer
    from repro_torch.data.loader import SyntheticSFTLoader
    from repro_torch.data.packing import build_minibatch
    from repro_torch.models import transformer as T

    cfg = get_reduced("qwen-1.5b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    loader = SyntheticSFTLoader("longalign", vocab_size=cfg.vocab_size,
                                world_size=2, minibatch_per_device=2,
                                max_tokens=128, max_len=250, seed=0,
                                strategy="lb_token", cp=2)
    steps = list(loader.steps(2))
    losses = {}
    for dev in ("cpu", "cuda"):
        tr = Trainer(cfg, RankGroup.make(2, dev), comm="cp", cp=2)
        shards, opt = tr.init_state(_to(params, dev))
        before = fa.state_launches
        losses[dev] = []
        for sd in steps:
            batch = build_minibatch(sd["plan"], sd["sample_tokens"], 128)
            counts = [len(a) for a in sd["plan"].assignments]
            shards, opt, m = tr.step(shards, opt, batch, counts)
            losses[dev].append(float(m["loss"]))
        if dev == "cuda":
            assert fa.state_launches > before
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-5 * abs(b), (losses["cuda"], losses["cpu"])


# ---------------------------------------------------------------------------
# the int8 codec and the compressed (q8) rings
# ---------------------------------------------------------------------------
def _codec_input(dev, size, seed):
    """Values of mixed scales, with an all-zero chunk, exact ties (a chunk
    whose absmax is 127, so scale 1 and x.5 is a tie) and a chunk whose
    extremes land on +-127."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(size, generator=g, device=dev)
    x *= 10.0 ** torch.randint(-3, 4, (size,), generator=g, device=dev)
    if size >= 3 * 256:
        x[:256] = 0.0
        x[256:512] = torch.arange(256, device=dev) % 9 - 4 + 0.5
        x[256] = 127.0
        x[512:768] = torch.linspace(-3.0, 3.0, 256, device=dev)
    return x


@pytest.mark.parametrize("size", [1, 255, 3 * 256, 10_000, 2 ** 20 + 3])
def test_codec_kernels_match_plain(cuda, size):
    from repro_torch.core import odc
    from repro_torch.kernels import quant as Q

    x = _codec_input(cuda, size, size)
    before = (Q.quantize_launches, Q.dequantize_launches)
    q, s = Q.quantize_int8(x)
    y = Q.dequantize_int8(q, s, x.shape)
    torch.cuda.synchronize()
    assert (Q.quantize_launches, Q.dequantize_launches) == \
        (before[0] + 1, before[1] + 1)
    qr, sr = odc.quantize_chunked(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(y, odc.dequantize_chunked(qr, sr, x.shape))
    assert int(q.min()) >= -127


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("ordered", [False, True])
def test_q8_ring_kernels_match_plain_rings(cuda, n, ordered):
    """Bitwise: the gather relays the codes, and the scatter requantizes
    and adds in the plain ring's hop order."""
    from repro_torch.core import odc
    from repro_torch.kernels import quant as Q

    order = list(reversed(range(n))) if ordered else None
    gen = torch.Generator(device=cuda).manual_seed(n)
    for c in (1, 1000, 4099):
        xs = [torch.randn(c, 3, generator=gen, device=cuda)
              for _ in range(n)]
        before = Q.gather_launches
        out = Q.odc_gather_q8(xs, order)
        torch.cuda.synchronize()
        assert Q.gather_launches == before + 1
        ref = odc.ring_gather_q8(xs, order)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
        ys = [torch.randn(n * c, 3, generator=gen, device=cuda)
              for _ in range(n)]
        before = Q.scatter_launches
        out = Q.odc_scatter_accumulate_q8(ys, order)
        torch.cuda.synchronize()
        assert Q.scatter_launches == before + 1
        ref = odc.ring_scatter_accumulate_q8(ys, order)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))


def test_q8_gather_takes_any_grid(cuda):
    """The q8 gather is the broadcast over codes and scales: any grid
    gives the plain ring's bits, so do sources off 16 bytes (codes at
    storage offset 1, scales at offset 1), and a grid outside [1, 2**31)
    is refused before launch."""
    from repro_torch.core import odc
    from repro_torch.kernels import quant as Q

    n, nc, order = 3, 37, [2, 0, 1]
    gen = torch.Generator(device=cuda).manual_seed(9)
    enc = [Q.quantize_int8(torch.randn(nc * 256, generator=gen,
                                       device=cuda)) for _ in range(n)]
    qs, ss = [q for q, _ in enc], [s for _, s in enc]
    ref = (odc.ring_gather(qs, order), odc.ring_gather(ss, order))
    for grid in (1, 7, None, 1 << 20):
        q_out, s_out = Q.gather_codes(qs, ss, order, blocks_per_rank=grid)
        torch.cuda.synchronize()
        assert all(torch.equal(a.view(-1, 256), b)
                   for a, b in zip(q_out, ref[0])), grid
        assert all(torch.equal(a.view(-1, 1), b)
                   for a, b in zip(s_out, ref[1])), grid
    qv = [torch.cat([q.new_zeros(1), q.view(-1)])[1:].view(nc, 256)
          for q in qs]
    sv = [torch.cat([s.new_zeros(1), s.view(-1)])[1:].view(nc, 1)
          for s in ss]
    assert all(t.data_ptr() % 16 for t in qv + sv)
    for grid in (1, 7, None):
        q_out, s_out = Q.gather_codes(qv, sv, blocks_per_rank=grid)
        torch.cuda.synchronize()
        assert all(torch.equal(a.view(-1, 256), b)
                   for a, b in zip(q_out, odc.ring_gather(qs))), grid
        assert all(torch.equal(a.view(-1, 1), b)
                   for a, b in zip(s_out, odc.ring_gather(ss))), grid
    xs = [torch.randn(1000, 3, generator=gen, device=cuda) for _ in range(n)]
    for grid in (1, 7, 1 << 20):
        out = Q.odc_gather_q8(xs, order, blocks_per_rank=grid)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in
                   zip(out, odc.ring_gather_q8(xs, order))), grid
    before = Q.gather_launches
    with pytest.raises(ValueError, match="blocks_per_rank"):
        Q.gather_codes(qs, ss, blocks_per_rank=0)
    assert Q.gather_launches == before


def test_q8_scatter_refuses_a_grid_that_cannot_be_resident(cuda):
    """The q8 scatter is still a ring whose blocks wait on each other, so
    a grid that cannot all be resident is refused before it runs, and the
    card is usable after it."""
    from repro_torch.core import odc
    from repro_torch.kernels import quant as Q

    ys = [torch.ones(2048, device=cuda) for _ in range(4)]
    before = Q.scatter_launches
    with pytest.raises(RuntimeError, match="resident"):
        Q.odc_scatter_accumulate_q8(ys, blocks_per_rank=1 << 20)
    assert Q.scatter_launches == before
    with pytest.raises(ValueError, match="int8"):
        Q.dequantize_int8(torch.ones(2, 256, device=cuda), torch.ones(
            2, 1, device=cuda), (512,))
    out = Q.odc_scatter_accumulate_q8(ys)
    torch.cuda.synchronize()
    assert Q.scatter_launches == before + 1
    assert all(torch.equal(a, b) for a, b in
               zip(out, odc.ring_scatter_accumulate_q8(ys)))


@pytest.mark.parametrize("comm", ["hier", "pipe", "pipe-int8"])
def test_reduced_two_tier_train_steps_on_card_match_cpu(cuda, comm):
    """Two reduced train steps on a 2 x 2 layout on the card (ring and q8
    kernels) against the same steps on the CPU (plain versions): losses
    within 1e-5 relative, as above; pipe-int8 quantizes the same gathered
    values on both, so its codes differ only where f32 rounding of the
    step-1 parameters moves a value across a rounding boundary."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.ranks import RankGroup
    from repro_torch.core.train_step import Trainer
    from repro_torch.data.loader import SyntheticSFTLoader
    from repro_torch.data.packing import build_minibatch
    from repro_torch.kernels import odc_gather as G
    from repro_torch.kernels import quant as Q
    from repro_torch.models import transformer as T

    cfg = get_reduced("qwen-1.5b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    loader = SyntheticSFTLoader("longalign", vocab_size=cfg.vocab_size,
                                world_size=4, minibatch_per_device=2,
                                max_tokens=128, max_len=120, seed=0)
    steps = list(loader.steps(2))
    losses = {}
    for dev in ("cpu", "cuda"):
        tr = Trainer(cfg, RankGroup.make(4, dev), comm=comm, inter=2)
        shards, opt = tr.init_state(_to(params, dev))
        before = (G.launches, Q.gather_launches, Q.scatter_launches,
                  Q.quantize_launches, Q.dequantize_launches)
        losses[dev] = []
        for sd in steps:
            batch = build_minibatch(sd["plan"], sd["sample_tokens"], 128)
            counts = [len(a) for a in sd["plan"].assignments]
            shards, opt, m = tr.step(shards, opt, batch, counts)
            losses[dev].append(float(m["loss"]))
        after = (G.launches, Q.gather_launches, Q.scatter_launches,
                 Q.quantize_launches, Q.dequantize_launches)
        moved = [a > b for a, b in zip(after, before)]
        if dev == "cuda":
            assert moved == ([False, True, True, True, True]
                             if comm == "pipe-int8" else
                             [True, False, False, False, False])
        else:
            assert not any(moved)
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-5 * abs(b), (losses["cuda"], losses["cpu"])


# ---------------------------------------------------------------------------
# the Mamba2 SSD scan kernel (ssm family)
# ---------------------------------------------------------------------------
# kernel vs plain, |diff| <= tol * (1 + |plain|): both sum the chunk's
# decay alike (f64, rounded once) and differ in the order of the f32 sums
# over Q and n only (the H100 reads 3.4e-7 at mamba2's shapes); bfloat16 y
# is one bf16 rounding of nearly equal f32 values, at most one step
# (2**-7 of |y|).  Tighter than the reference's kernel-vs-oracle 1e-4 and
# 5e-2 (tests/test_kernels.py:198), as chip_smoke.py's SSD_TOL
SSD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# the scan's gradient, kernel route (its backward differentiates
# ssd_chunked) against autograd through the plain version: two f32
# algorithms.  Each is within 1.31e-3 of the float64 gradient at the test's
# shape (dA; 2.1e-4 dt, 1.4e-4 the others; measured on the CPU): the
# chunk's cumulative decay reaches |acum| ~ 180 at Q = 256, whose f32
# rounding exp() turns into a relative error, so the two may differ by
# twice that
SSD_GRAD_TOL = 2e-3


def _ssd_inputs(dev, dtype, b, s, h, p, g, n, *, pad=0, seed=0):
    """Seeded scan inputs as ``mamba2_apply`` makes them; the last ``pad``
    positions are a padded tail (x, B, C zero, dt 0)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    x = rnd(b, s, h, p) * 0.5
    dt = torch.nn.functional.softplus(rnd(b, s, h))
    A = -torch.exp(rnd(h) * 0.3)
    Bm, Cm = rnd(b, s, g, n) * 0.5, rnd(b, s, g, n) * 0.5
    if pad:
        for t in (x, dt, Bm, Cm):
            t[:, s - pad:] = 0
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,Q,pad", [
    (2, 64, 4, 16, 1, 8, 16, 0),
    (1, 128, 8, 32, 2, 16, 32, 0),
    (2, 96, 6, 8, 3, 4, 32, 0),
    (1, 64, 2, 64, 2, 64, 64, 0),
    (2, 512, 8, 64, 1, 128, 256, 0),   # mamba2's head dim and state
    (1, 384, 4, 64, 1, 128, 256, 0),   # a chunk of 256 over 384: refused
    (2, 512, 8, 64, 1, 128, 256, 40),  # a padded tail with dt = 0
    (1, 40, 3, 128, 1, 32, 40, 0),
])
def test_ssd_kernel_matches_plain(cuda, dtype, b, s, h, p, g, n, Q, pad):
    from repro_torch.kernels import ssd_scan as K

    x, dt, A, Bm, Cm = _ssd_inputs(cuda, dtype, b, s, h, p, g, n, pad=pad)
    if s % min(Q, s):
        with pytest.raises(ValueError, match="divisible"):
            K.ssd_scan(x, dt, A, Bm, Cm, Q)
        return
    before = K.launches
    y, st = K.ssd_scan(x, dt, A, Bm, Cm, Q)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    ry, rst = K.ssd_scan_plain(x, dt, A, Bm, Cm, Q)
    assert y.dtype == dtype and st.dtype == torch.float32
    tol = SSD_TOL[dtype]
    for out, ref in ((y.float(), ry.float()), (st, rst)):
        assert torch.isfinite(out).all()
        err = (out - ref).abs()
        assert (err <= tol * (1 + ref.abs())).all(), float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,Q,pad", [
    (2, 256, 8, 64, 1, 128, 256, 0),   # one chunk: no entering state
    (1, 192, 4, 64, 1, 128, 48, 0),    # Q not a multiple of 64
    (2, 192, 4, 32, 1, 64, 96, 0),     # a query tile of 32 rows
    (1, 256, 8, 64, 2, 32, 64, 0),     # g = 2: four heads a group
    (2, 512, 8, 64, 1, 128, 256, 40),  # a padded tail with dt = 0
    (1, 96, 3, 5, 1, 6, 32, 0),        # p, n off 4: staged in registers
])
def test_ssd_sequence_edges_match_plain(cuda, dtype, b, s, h, p, g, n, Q,
                                        pad):
    """The chunk-parallel sequence at the edges its tiling makes: the
    kernel against ``ssd_scan_plain`` at SSD_TOL, y and the final state."""
    from repro_torch.kernels import ssd_scan as K

    x, dt, A, Bm, Cm = _ssd_inputs(cuda, dtype, b, s, h, p, g, n, pad=pad,
                                   seed=3)
    y, st = K.ssd_scan(x, dt, A, Bm, Cm, Q)
    torch.cuda.synchronize()
    ry, rst = K.ssd_scan_plain(x, dt, A, Bm, Cm, Q)
    assert y.dtype == dtype and st.dtype == torch.float32
    tol = SSD_TOL[dtype]
    for out, ref in ((y.float(), ry.float()), (st, rst)):
        assert torch.isfinite(out).all()
        err = (out - ref).abs()
        assert (err <= tol * (1 + ref.abs())).all(), float(err.max())


def test_ssd_scan_counts_one_launch_per_call(cuda):
    """``launches`` rises by exactly one per call, for the whole sequence
    of kernels, and not for the plain version."""
    from repro_torch.kernels import ssd_scan as K

    ins = _ssd_inputs(cuda, torch.float32, 2, 128, 4, 32, 1, 16)
    before = K.launches
    for i in range(3):
        K.ssd_scan(*ins, 32)
        assert K.launches == before + i + 1
    K.ssd_scan_plain(*ins, 32)
    torch.cuda.synchronize()
    assert K.launches == before + 3


def test_ssd_kernel_refuses_before_launch(cuda):
    from repro_torch.kernels import ssd_scan as K

    before = K.launches
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, torch.float32, 1, 32, 2, 160, 1,
                                   16)
    with pytest.raises(ValueError, match="at most"):
        K.ssd_scan(x, dt, A, Bm, Cm, 32)
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, torch.float32, 1, 32, 2, 16, 1, 16)
    with pytest.raises(TypeError):
        K.ssd_scan(x, dt, A, Bm.bfloat16(), Cm, 32)
    with pytest.raises(TypeError):
        K.ssd_scan(x, dt.double(), A, Bm, Cm, 32)
    assert K.launches == before


def test_ssd_largest_chunks_run_and_one_more_is_refused(cuda):
    """A chunk of 16384 (its acum fills most of a states block's shared
    memory) against ``ssd_scan_plain`` at SSD_TOL; one position past
    ``MAX_Q`` is refused with a ValueError before any launch."""
    from repro_torch.kernels import ssd_scan as K

    Q = 16384
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, torch.float32, 1, Q, 2, 8, 1, 8)
    y, st = K.ssd_scan(x, dt, A, Bm, Cm, Q)
    torch.cuda.synchronize()
    ry, rst = K.ssd_scan_plain(x, dt, A, Bm, Cm, Q)
    for out, ref in ((y, ry), (st, rst)):
        assert torch.isfinite(out).all()
        err = (out - ref).abs()
        assert (err <= SSD_TOL[torch.float32] * (1 + ref.abs())).all(), \
            float(err.max())
    del x, dt, A, Bm, Cm, y, st, ry, rst
    before = K.launches
    Q = K.MAX_Q + 1
    ins = _ssd_inputs(cuda, torch.float32, 1, Q, 2, 8, 1, 8)
    with pytest.raises(ValueError, match="at most"):
        K.ssd_scan(*ins, Q)
    assert K.launches == before


def test_ssd_kernel_gradient_matches_plain(cuda):
    """Kernel forward + ``ssd_chunked`` backward against autograd through
    the plain version, |diff| <= SSD_GRAD_TOL * (1 + |plain|) in f32."""
    from repro_torch.kernels import ssd_scan as K

    ins = _ssd_inputs(cuda, torch.float32, 1, 512, 4, 64, 1, 128)
    gen = torch.Generator(device=cuda).manual_seed(5)
    gy = torch.randn(ins[0].shape, generator=gen, device=cuda)
    gs = torch.randn((1, 4, 64, 128), generator=gen, device=cuda)
    grads = []
    for fn in (K.ssd_scan, K.ssd_scan_plain):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        y, st = fn(*leaves, 256)
        torch.autograd.backward([y, st], [gy, gs])
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.isfinite(a).all()
        assert ((a - b).abs() <= SSD_GRAD_TOL * (1 + b.abs())).all(), \
            float((a - b).abs().max())


def test_reduced_mamba_serve_on_card_matches_cpu(cuda):
    """Reduced mamba2 prefill and one decode step on the card (scan
    kernel) against the CPU (plain version), same weights: logits within
    1e-4 (products and sums in another order)."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import ssd_scan as K
    from repro_torch.models import transformer as T
    from repro_torch.posttrain.engine import GenerationEngine

    cfg = get_reduced("mamba2-2.7b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(1, cfg.vocab_size, (4, 40),
                           generator=torch.Generator().manual_seed(1))
    logits = {}
    for dev in ("cpu", "cuda"):
        eng = GenerationEngine(cfg, device=dev)
        p = _to(params, dev)
        before = K.launches
        out, cache = eng.prefill(p, eng.prompt_batch(tokens),
                                 eng.init_cache(4, 48))
        nxt = out[:, -1].argmax(-1)[:, None]
        out2, _ = eng.decode(p, cache, nxt, 40)
        logits[dev] = torch.cat([out, out2], dim=1).cpu()
        assert K.launches - before == (cfg.num_layers if dev == "cuda"
                                       else 0)
    err = (logits["cuda"] - logits["cpu"]).abs()
    assert (err <= 1e-4 * (1 + logits["cpu"].abs())).all(), float(err.max())


@pytest.mark.parametrize("comm,schedule", [("odc", "minibatch"),
                                           ("collective", "layer"),
                                           ("odc-overlap", "overlap")])
def test_reduced_mamba_train_steps_on_card_match_cpu(cuda, comm, schedule):
    """Two reduced mamba2 train steps with two ranks on the card (scan and
    ring kernels) against the same steps on the CPU: losses within 1e-5
    relative, as for qwen."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.ranks import RankGroup
    from repro_torch.core.train_step import Trainer
    from repro_torch.data.loader import SyntheticSFTLoader
    from repro_torch.data.packing import build_minibatch
    from repro_torch.kernels import ssd_scan as K
    from repro_torch.models import transformer as T

    cfg = get_reduced("mamba2-2.7b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    loader = SyntheticSFTLoader("longalign", vocab_size=cfg.vocab_size,
                                world_size=2, minibatch_per_device=2,
                                max_tokens=128, max_len=120, seed=0)
    steps = list(loader.steps(2))
    losses = {}
    for dev in ("cpu", "cuda"):
        tr = Trainer(cfg, RankGroup.make(2, dev), comm=comm,
                     schedule=schedule)
        shards, opt = tr.init_state(_to(params, dev))
        before = K.launches
        losses[dev] = []
        for sd in steps:
            batch = build_minibatch(sd["plan"], sd["sample_tokens"], 128)
            counts = [len(a) for a in sd["plan"].assignments]
            shards, opt, m = tr.step(shards, opt, batch, counts)
            losses[dev].append(float(m["loss"]))
        assert (K.launches > before) == (dev == "cuda")
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-5 * abs(b), (losses["cuda"], losses["cpu"])


# ===========================================================================
# gather_matmul
# ===========================================================================
# kernel vs plain: |diff| <= tol * max|plain| over the rank's output.  f32:
# both sum each hop's c-term dots in f32, in another order (and the plain
# one through the library's blocking); bf16: both sum the exact products
# in f32 and round once, so at most one bf16 step (2**-7) apart
GM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _gm_inputs(dev, dtype, n, m, k, f, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    xs = [torch.randn((m, k), generator=g, device=dev).to(dtype)
          for _ in range(n)]
    ws = [torch.randn((k // n, f), generator=g, device=dev).to(dtype)
          for _ in range(n)]
    return xs, ws


def _gm_launch(GM, xs, ws, want_route):
    """One call, which must launch once on ``want_route`` (route counters)
    for either dtype: bf16 on the route the shapes give, f32 always on
    the CUDA cores."""
    n, (m, k), f = len(xs), xs[0].shape, ws[0].shape[1]
    rt = want_route if xs[0].dtype == torch.bfloat16 else "simt"
    assert GM.route(n, m, k, f, xs[0].dtype) == rt
    before = (GM.launches, GM.launches_tc, GM.launches_simt)
    outs = GM.gather_matmul(xs, ws)
    torch.cuda.synchronize()
    assert (GM.launches, GM.launches_tc, GM.launches_simt) == (
        before[0] + 1, before[1] + (rt == "tc"), before[2] + (rt == "simt"))
    return outs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,k,f,bf16_route", [
    (2, 64, 128, 64, "tc"), (4, 100, 96, 70, "simt"),
    (3, 7, 9, 5, "simt"), (2, 256, 1536, 896, "tc"),
    # c = 72, not a multiple of the tensor cores' 64-row k step
    (2, 200, 144, 256, "tc"),
    # f = 200, not a multiple of either route's column tile
    (2, 130, 128, 200, "tc"),
    (2, 1, 128, 64, "tc"),  # m = 1
    (16, 96, 384, 136, "tc"),  # 16 ranks, c = 24
    (2, 64, 24, 64, "simt"),  # c = 12: 24-byte bf16 rows, off TMA's 16
])
def test_gather_matmul_kernel_matches_plain(cuda, dtype, n, m, k, f,
                                            bf16_route):
    from repro_torch.kernels import gather_matmul as GM

    xs, ws = _gm_inputs(cuda, dtype, n, m, k, f, seed=n * 1000 + m)
    outs = _gm_launch(GM, xs, ws, bf16_route)
    before = GM.launches
    ref = GM.gather_matmul_plain(xs, ws)
    assert GM.launches == before
    for o, r in zip(outs, ref):
        assert o.dtype == dtype and o.shape == (m, f)
        err = float((o.float() - r.float()).abs().max())
        assert torch.isfinite(o.float()).all()
        assert err <= GM_TOL[dtype] * float(r.float().abs().max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,k,f,bf16_route", [
    (2, 40, 144, 64, "tc"), (3, 40, 72, 64, "tc"),
    (3, 20, 39, 24, "simt")])
def test_gather_matmul_keeps_each_hop_to_its_shard(cuda, dtype, n, m, k,
                                                   f, bf16_route):
    """An inf in x's first columns of shard s + 1 (those a k step past
    the end of shard s would reach, c not a multiple of the step) makes
    its row of the output +-inf through its own hop only: the plain
    version gives +-inf by the sign of W, and a read of those columns
    with shard s's zero-filled rows past c would make NaN (0 * inf).
    Even rows hold one inf each, odd rows none."""
    from repro_torch.kernels import gather_matmul as GM

    xs, ws = _gm_inputs(cuda, dtype, n, m, k, f, seed=11)
    ws = [torch.where(w == 0, torch.ones_like(w), w) for w in ws]
    c = k // n
    for x in xs:
        for row in range(0, m, 2):
            x[row, (row // 2) % n * c + row % min(c, 8)] = float("inf")
    outs = _gm_launch(GM, xs, ws, bf16_route)
    ref = GM.gather_matmul_plain(xs, ws)
    for o, r in zip(outs, ref):
        o, r = o.float(), r.float()
        assert not torch.isnan(r).any()
        assert torch.equal(torch.isinf(o), torch.isinf(r))
        assert torch.equal(o[torch.isinf(r)], r[torch.isinf(r)])
        fin = torch.isfinite(r)
        assert (o[fin] - r[fin]).abs().max() <= GM_TOL[dtype] * max(
            1.0, float(r[fin].abs().max()))


def test_gather_matmul_refuses_before_launch(cuda):
    from repro_torch.kernels import gather_matmul as GM

    x = [torch.zeros((4, 8), device=cuda) for _ in range(2)]
    w = [torch.zeros((4, 3), device=cuda) for _ in range(2)]
    before = GM.launches
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        GM.gather_matmul([x[0], x[1].cpu()], w)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        GM.gather_matmul([t.half() for t in x], [t.half() for t in w])
    with pytest.raises(ValueError, match="contiguous"):
        GM.gather_matmul([torch.zeros((8, 4), device=cuda).T, x[1]], w)
    with pytest.raises(ValueError, match="k = 8 columns"):
        GM.gather_matmul(x, [t[:3] for t in w])
    assert GM.launches == before


# ===========================================================================
# the hybrid family (zamba2)
# ===========================================================================
def _zamba5():
    from repro_torch.configs import get_config
    from repro_torch.models.config import reduced

    return reduced(get_config("zamba2-1.2b"), num_layers=5)


def test_reduced_hybrid_serve_on_card_matches_cpu(cuda):
    """5-layer zamba2 prefill and one decode step on the card (scan and
    flash kernels) against the CPU (plain versions), same weights: logits
    within 1e-4 (products and sums in another order)."""
    from repro_torch.kernels import ssd_scan as K
    from repro_torch.models import transformer as T
    from repro_torch.posttrain.engine import GenerationEngine

    cfg = _zamba5()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(1, cfg.vocab_size, (4, 40),
                           generator=torch.Generator().manual_seed(1))
    logits = {}
    for dev in ("cpu", "cuda"):
        eng = GenerationEngine(cfg, device=dev)
        p = _to(params, dev)
        scans, attn = K.launches, fa.launches
        out, cache = eng.prefill(p, eng.prompt_batch(tokens),
                                 eng.init_cache(4, 48))
        nxt = out[:, -1].argmax(-1)[:, None]
        out2, _ = eng.decode(p, cache, nxt, 40)
        logits[dev] = torch.cat([out, out2], dim=1).cpu()
        on = dev == "cuda"
        assert K.launches - scans == (cfg.num_layers if on else 0)
        # two invocations of the shared block, in the prefill and decode
        assert fa.launches - attn == (2 * 2 if on else 0)
    err = (logits["cuda"] - logits["cpu"]).abs()
    assert (err <= 1e-4 * (1 + logits["cpu"].abs())).all(), float(err.max())


@pytest.mark.parametrize("comm,schedule", [("odc", "minibatch"),
                                           ("collective", "layer"),
                                           ("odc-overlap", "overlap")])
def test_reduced_hybrid_train_steps_on_card_match_cpu(cuda, comm, schedule):
    """Two 5-layer zamba2 train steps with two ranks on the card (scan,
    flash and ring kernels) against the same steps on the CPU: losses
    within 1e-5 relative, as for qwen."""
    from repro_torch.core.ranks import RankGroup
    from repro_torch.core.train_step import Trainer
    from repro_torch.data.loader import SyntheticSFTLoader
    from repro_torch.data.packing import build_minibatch
    from repro_torch.kernels import ssd_scan as K
    from repro_torch.models import transformer as T

    cfg = _zamba5()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    loader = SyntheticSFTLoader("longalign", vocab_size=cfg.vocab_size,
                                world_size=2, minibatch_per_device=2,
                                max_tokens=128, max_len=120, seed=0)
    steps = list(loader.steps(2))
    losses = {}
    for dev in ("cpu", "cuda"):
        tr = Trainer(cfg, RankGroup.make(2, dev), comm=comm,
                     schedule=schedule)
        shards, opt = tr.init_state(_to(params, dev))
        before = K.launches, fa.launches
        losses[dev] = []
        for sd in steps:
            batch = build_minibatch(sd["plan"], sd["sample_tokens"], 128)
            counts = [len(a) for a in sd["plan"].assignments]
            shards, opt, m = tr.step(shards, opt, batch, counts)
            losses[dev].append(float(m["loss"]))
        after = K.launches, fa.launches
        assert all((a > b) == (dev == "cuda") for a, b in zip(after, before))
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-5 * abs(b), (losses["cuda"], losses["cpu"])


# ===========================================================================
# the moe family (grok-1)
# ===========================================================================
def test_reduced_moe_serve_on_card_matches_plain_route(cuda):
    """Reduced grok-1 (2 moe layers, 4 experts top-2) prefill and one
    decode step with the router tallies on the card, on the flash kernel
    and on the plain attention route, same weights: the routing held by
    ``moe.routing_rule`` (``chip_smoke._hold_routing``, which fails on a
    fault), then the logits of the rows with no near-tie
    within 1e-5 of 1 + |plain|, and the tallies equal."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    from repro_torch.posttrain.engine import GenerationEngine

    cfg = get_reduced("grok-1-314b")
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(1, cfg.vocab_size, (4, 40),
                           generator=torch.Generator().manual_seed(1))
    eng = GenerationEngine(cfg, device="cuda")
    out, calls = {}, {}
    for route in ("kernel", "plain"):
        prev = layers.set_attention_impl(
            fa.flash_attention_plain if route == "plain" else None)
        before = fa.launches
        try:
            with chip_smoke._Routing() as rec:
                logits, cache = eng.prefill(
                    params, eng.prompt_batch(tokens), eng.init_cache(4, 48))
                nxt = logits[:, -1].argmax(-1)[:, None]
                logits2, cache = eng.decode(params, cache, nxt, 40)
        finally:
            layers.set_attention_impl(prev)
        assert fa.launches - before == (2 * 2 if route == "kernel" else 0)
        out[route] = (torch.cat([logits, logits2], 1),
                      cache["moe"]["router_counts"])
        calls[route] = rec.calls
    ok = chip_smoke._hold_routing("reduced grok-1", calls["plain"],
                                  calls["kernel"], 4).to(cuda)
    assert ok.any()
    got, want = out["kernel"][0][ok], out["plain"][0][ok]
    err = (got - want).abs()
    assert (err <= 1e-5 * (1 + want.abs())).all(), float(err.max())
    if ok.all():  # no near-tie: every token went where it went before
        assert torch.equal(out["kernel"][1], out["plain"][1])


def test_reduced_moe_odc_step_matches_collective_on_card(cuda):
    """One reduced grok-1 train step with two ranks on the card, ODC x
    minibatch (ring kernels) against collective x layer: the step-0 losses
    equal (the same forward) and the gradient norms within 1e-5."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.ranks import RankGroup
    from repro_torch.core.train_step import Trainer
    from repro_torch.data.loader import SyntheticSFTLoader
    from repro_torch.data.packing import build_minibatch
    from repro_torch.kernels import odc_gather as KG
    from repro_torch.models import transformer as T

    cfg = get_reduced("grok-1-314b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    loader = SyntheticSFTLoader("longalign", vocab_size=cfg.vocab_size,
                                world_size=2, minibatch_per_device=2,
                                max_tokens=128, max_len=120, seed=0)
    sd = next(loader.steps(1))
    batch = build_minibatch(sd["plan"], sd["sample_tokens"], 128)
    counts = [len(a) for a in sd["plan"].assignments]
    res = {}
    for comm, schedule in (("collective", "layer"), ("odc", "minibatch")):
        tr = Trainer(cfg, RankGroup.make(2, "cuda"), comm=comm,
                     schedule=schedule)
        shards, opt = tr.init_state(_to(params, "cuda"))
        before = KG.launches, fa.launches
        _, _, m = tr.step(shards, opt, batch, counts)
        res[comm] = (float(m["loss"]), float(m["grad_norm"]))
        assert fa.launches > before[1]
        assert (KG.launches > before[0]) == (comm == "odc")
    (la, na), (lb, nb) = res["collective"], res["odc"]
    assert la == lb, res
    assert abs(na - nb) <= 1e-5 * nb, res


# ===========================================================================
# the audio family (seamless-m4t-medium)
# ===========================================================================
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["seamless encoder serve",
                                  "seamless cross prefill",
                                  "seamless cross decode",
                                  "seamless train cross"])
def test_seamless_attention_shapes_match_plain(cuda, dtype, name):
    """The encoder's and the cross-attention's calls at seamless's shapes
    (non-causal, S != T, no segment ids), the cross decode on the decode
    path."""
    B, S, T, H, KH, hd, opt = chip_smoke.ATTN_CASES[name]
    q, k, v, kw = chip_smoke._attn_case(B, S, T, H, KH, hd, dtype, seed=5,
                                        **opt)
    plan = fa.launch_plan(B, S, T, H, KH, hd, dtype)
    assert plan["decode"] == (name == "seamless cross decode")
    before = fa.launches
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert _close_on_valid_rows(out, fa.flash_attention_plain(q, k, v, **kw),
                                kw, dtype)


def test_reduced_audio_serve_on_card_matches_plain_route(cuda):
    """Reduced seamless (2 + 2 layers) prefill with its frames and one
    decode step from the cached encoder output, on the flash kernel and
    on the plain attention route, same weights: logits within 1e-5 of
    1 + |plain|, and 2 + 2 x 2 launches for the prefill, 2 x 2 for the
    decode step."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    from repro_torch.posttrain.engine import GenerationEngine

    cfg = get_reduced("seamless-m4t-medium")
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(1, cfg.vocab_size, (4, 40), generator=g)
    frames = torch.randn((4, 40, cfg.d_model), generator=g).to(cuda)
    eng = GenerationEngine(cfg, device="cuda")
    out = {}
    nxt = tokens[:, -1:].to(cuda)  # the same next token on both routes
    for route in ("kernel", "plain"):
        prev = layers.set_attention_impl(
            fa.flash_attention_plain if route == "plain" else None)
        before = fa.launches
        try:
            batch = dict(eng.prompt_batch(tokens), encoder_embeds=frames)
            logits, cache = eng.prefill(params, batch,
                                        eng.init_cache(4, 48, enc_len=40))
            mid = fa.launches
            logits2, cache = eng.decode(params, cache, nxt, 40)
        finally:
            layers.set_attention_impl(prev)
        if route == "kernel":
            assert (mid - before, fa.launches - mid) == (2 + 2 * 2, 2 * 2)
        else:
            assert fa.launches == before
        out[route] = torch.cat([logits, logits2], 1)
    err = (out["kernel"] - out["plain"]).abs()
    assert torch.isfinite(out["kernel"]).all()
    assert (err <= 1e-5 * (1 + out["plain"].abs())).all(), float(err.max())


def test_reduced_audio_odc_step_matches_collective_on_card(cuda):
    """One reduced seamless train step with two ranks on the card, with
    the train driver's frames, ODC x minibatch (ring kernels) against
    collective x layer: the step-0 losses equal (the same forward) and the
    gradient norms within 1e-5."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.ranks import RankGroup
    from repro_torch.core.train_step import Trainer
    from repro_torch.data.loader import SyntheticSFTLoader
    from repro_torch.data.packing import build_minibatch
    from repro_torch.kernels import odc_gather as KG
    from repro_torch.launch.train import stub_extras
    from repro_torch.models import transformer as T

    cfg = get_reduced("seamless-m4t-medium")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    loader = SyntheticSFTLoader("longalign", vocab_size=cfg.vocab_size,
                                world_size=2, minibatch_per_device=2,
                                max_tokens=128, max_len=120, seed=0)
    sd = next(loader.steps(1))
    batch = build_minibatch(sd["plan"], sd["sample_tokens"], 128,
                            extras=stub_extras(cfg, 0))
    counts = [len(a) for a in sd["plan"].assignments]
    res = {}
    for comm, schedule in (("collective", "layer"), ("odc", "minibatch")):
        tr = Trainer(cfg, RankGroup.make(2, "cuda"), comm=comm,
                     schedule=schedule)
        shards, opt = tr.init_state(_to(params, "cuda"))
        before = KG.launches, fa.launches
        _, _, m = tr.step(shards, opt, batch, counts)
        res[comm] = (float(m["loss"]), float(m["grad_norm"]))
        assert fa.launches > before[1]
        assert (KG.launches > before[0]) == (comm == "odc")
    (la, na), (lb, nb) = res["collective"], res["odc"]
    assert la == lb, res
    assert abs(na - nb) <= 1e-5 * nb, res


# ===========================================================================
# post-training: a GRPO step, the weight push, live pushes
# ===========================================================================
def _posttrain_argv(*flags):
    return ["--arch", "qwen-1.5b", "--reduced", "--device", "cuda",
            "--seed", "0", "--quiet", *flags]


def test_reduced_grpo_step_on_kernel_route_matches_plain_route(cuda):
    from repro_torch.launch import posttrain, train
    from repro_torch.models import layers

    argv = _posttrain_argv("--rollout", "synthetic", "--staleness", "0",
                           "--iters", "1")
    train.reset_launches()
    kern = posttrain.run(posttrain.parse_args(argv + ["--comm", "odc"]))
    launches = train.read_launches()
    prev = layers.set_attention_impl(fa.flash_attention_plain)
    try:
        train.reset_launches()
        plain = posttrain.run(posttrain.parse_args(
            argv + ["--comm", "collective"]))
        plain_launches = train.read_launches()
    finally:
        layers.set_attention_impl(prev)
    l0, p0 = kern["metrics"][0]["loss"], plain["metrics"][0]["loss"]
    assert launches["flash_attention"] > 0 and launches["odc_gather"] > 0
    assert launches["odc_scatter_accumulate"] > 0
    assert sum(plain_launches.values()) == 0
    assert abs(l0 - p0) <= 1e-5 * abs(p0)


def test_odc_push_is_the_trainers_parameters_bitwise(cuda):
    from repro_torch.kernels import odc_gather
    from repro_torch.launch import posttrain
    from repro_torch.posttrain.weight_push import push_comm_sites

    built = posttrain.build(posttrain.parse_args(_posttrain_argv(
        "--rollout", "engine", "--comm", "odc")))
    trainer, shards, pusher = built[1], built[2], built[6]
    sites = push_comm_sites(trainer, shards)
    before = odc_gather.launches
    params = pusher.push(shards, 0)
    assert odc_gather.launches - before == len(sites) > 0
    full = trainer.unshard(shards, "cuda")
    for a, b in zip(chip_smoke._leaves(params), chip_smoke._leaves(full)):
        assert a.is_cuda and chip_smoke._bits(a).equal(chip_smoke._bits(b))


@pytest.mark.parametrize("comm", ["collective", "odc"])
def test_continuous_run_with_live_pushes(cuda, comm):
    from repro_torch.launch import posttrain

    summary = posttrain.run(posttrain.parse_args(_posttrain_argv(
        "--rollout", "continuous", "--slots", "4", "--comm", comm,
        "--staleness", "1", "--iters", "3")))
    # v0 before wave 0, v1 before wave 2 (waves 0 and 1 ride v0)
    assert summary["pushes"] == 2
    assert [m["staleness"] for m in summary["metrics"]] == [0, 1, 1]
    assert all(np.isfinite(m["loss"]) for m in summary["metrics"])
    assert (summary["push_stall_s"] > 0) == (comm == "collective")
