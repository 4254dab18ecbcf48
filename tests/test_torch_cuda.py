"""Card tests of the port: the CUDA flash-attention kernel against its
plain version, its gradient, its launch counter and its input checks; the
ODC ring kernels against the plain rings and their refusal of a grid that
cannot be co-resident; a reduced serve run and a reduced train step on the
card against the same run on the CPU.  Each test needs an NVIDIA GPU and
skips without one.

This file imports no jax, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jax.)  Tolerance on rows
with at least one valid key, |diff| <= TOL * (1 + |plain|): float32 1e-5
(sum order), bfloat16 1e-2 (one bf16 rounding step of the output).  The
flash gradient, kernel route against plain route, 1e-4 in f32 (the
backward's T-term sums in another order).  The rings: bitwise (they move
data, and the scatter adds in the plain ring's hop order).
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

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
@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("ordered", [False, True])
def test_ring_kernels_match_plain_rings(cuda, dtype, n, ordered):
    from repro_torch.kernels import odc_gather as G
    from repro_torch.kernels import odc_scatter as S

    order = list(reversed(range(n))) if ordered else None
    gen = torch.Generator(device=cuda).manual_seed(n)
    for c in (1, 1000, 4099):
        xs = [torch.randn(c, 3, generator=gen, device=cuda).to(dtype)
              for _ in range(n)]
        before = G.launches
        out = G.odc_gather(xs, order)
        torch.cuda.synchronize()
        assert G.launches == before + 1
        ref = G.odc_gather_plain(xs, order)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
        ys = [torch.randn(n * c, 3, generator=gen, device=cuda).to(dtype)
              for _ in range(n)]
        before = S.launches
        out = S.odc_scatter_accumulate(ys, order)
        torch.cuda.synchronize()
        assert S.launches == before + 1
        ref = S.odc_scatter_accumulate_plain(ys, order)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))


def test_ring_refuses_a_grid_that_cannot_be_resident(cuda):
    from repro_torch.kernels import odc_gather as G
    from repro_torch.kernels import odc_scatter as S

    xs = [torch.ones(64, device=cuda) for _ in range(4)]
    for fn, mod in ((G.odc_gather, G), (S.odc_scatter_accumulate, S)):
        before = mod.launches
        with pytest.raises(RuntimeError, match="resident"):
            fn(xs, blocks_per_rank=1 << 20)
        assert mod.launches == before
    with pytest.raises(TypeError):
        G.odc_gather([x.half() for x in xs])
    with pytest.raises(ValueError, match="contiguous"):
        G.odc_gather([torch.ones(8, 2, device=cuda).t() for _ in range(2)])
    out = G.odc_gather(xs)  # the card is usable after a refusal
    torch.cuda.synchronize()
    assert all(torch.equal(o, torch.ones(256, device=cuda)) for o in out)


@pytest.mark.parametrize("comm,schedule", [("odc", "minibatch"),
                                           ("collective", "layer")])
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
        before = G.launches
        losses[dev] = []
        for sd in steps:
            batch = build_minibatch(sd["plan"], sd["sample_tokens"], 128)
            counts = [len(a) for a in sd["plan"].assignments]
            shards, opt, m = tr.step(shards, opt, batch, counts)
            losses[dev].append(float(m["loss"]))
        if dev == "cuda" and comm == "odc":
            assert G.launches > before
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-5 * abs(b), (losses["cuda"], losses["cpu"])
