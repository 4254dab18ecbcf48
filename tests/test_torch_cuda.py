"""Card tests of the port: the CUDA flash-attention kernel against its
plain version, its launch counter and its input checks, and a reduced
serve run on the card against the same run on the CPU.  Each test needs an
NVIDIA GPU and skips without one.

This file imports no jax, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jax.)  Tolerance on rows
with at least one valid key, |diff| <= TOL * (1 + |plain|): float32 1e-5
(sum order), bfloat16 1e-2 (one bf16 rounding step of the output).
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
