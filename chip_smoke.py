"""Chip smoke test of the PyTorch/CUDA port: builds the port's kernels,
holds each one to its plain PyTorch version on the card (flash attention
forward and gradient, the ODC ring gather and scatter-accumulate), serves
full-width qwen-1.5b through the serve entry point in both modes, trains
full-width qwen-1.5b with two ranks on the card through the train entry
point (ODC x minibatch and collective x layer), and times each kernel
against its bound and its library yardstick.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It exits non-zero, printing no result, when there is no CUDA device or the
repository's ``src/`` is not beside it.  The last line of its output is
``{"ok": true, "device": {...}}``, printed only when every phase passed;
the line before it is the kernels' JSON record.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Peaks of one H100 SXM (NVIDIA data sheet, dense): the f32 rate of the
# CUDA cores, the bf16 tensor-core rate, and the HBM3 rate.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12

# Kernel vs plain tolerance, |diff| <= TOL * (1 + |plain|), on rows with at
# least one valid key.  float32: both sides sum the 128-term dots and the
# T-term softmax in a different order (measured error below 1e-6 on the
# H100).  bfloat16: both compute in f32 from the same inputs, so the
# outputs differ by at most one bf16 rounding step (2**-7 relative).
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# Full-width prefill, kernel vs plain attention through 28 layers: the
# last-position logits in f32 (|logits| ~ 1).
LOGITS_TOL = 1e-3

# Flash gradient, kernel route (CUDA forward + ported backward) vs the
# plain route (autograd through the plain version), |diff| <= tol * (1 +
# |plain|): both in f32 from the same inputs, the T-term sums taken in
# another order (materialized softmax and autograd vs closed-form VJP).
GRAD_TOL = 1e-4
# Train, ODC x minibatch vs collective x layer.  Step 0: the same
# parameters and batches through the same forward, so the losses are
# equal (tolerance 0).  Its gradients are summed in another order (per
# rank over M microbatches, then over the n ranks; against per
# microbatch over the ranks), so each element differs by at most about
# 2*n*M*u of the sum of its |terms| (u = 2**-24; n = M = 2 here), and
# the step-0 global norms by about that relative (5e-7): 1e-5 is twenty
# times it.
# The norm is what a scatter that drops, repeats or rescales a rank's
# contribution changes, and AdamW with the norm clip hides a rescaled
# gradient from the losses.
GRAD_NORM_RTOL = 1e-5
# Later losses: AdamW's first steps move each weight by about
# lr * sign(g), so only elements whose gradient is within rounding of 0
# can move another way, and they move the loss by a second-order amount.
# Every sound run measured 0; the limit leaves room for a flip of that
# kind and no more (the readings of planted faulty scatters: PERF.md).
TRAIN_LOSS_RTOL = 1e-5

# The serve runs: qwen-1.5b at its published widths, fp32, one card.
ARCH = "qwen-1.5b"
WAVE = dict(batch=8, prompt_len=512, gen=32)
CONT = dict(slots=4, requests=12, length_spread=4.0, prompt_len=512, gen=32)
SEED = 0
# The train runs: qwen-1.5b at its published widths and depth, fp32, two
# ranks on the one card, LongAlign lengths planned by LB-Mini.
TRAIN = dict(data_axis=2, steps=3, max_tokens=4096, max_len=4096,
             minibatch_per_device=4)
TRAIN_CONFIGS = (("odc", "minibatch"), ("collective", "layer"))
# ring cases: ranks, shard elements, dtypes
RING_NS = (2, 3, 4, 8)
RING_SIZES = (1, 1000, 2 ** 20)
# qwen-1.5b's largest leaf, the stacked w_up (28, 1536, 8960), as each of
# 2 ranks holds it; and a 2**24-element shard on 4 ranks
W_UP_SHARD = (28, 768, 8960)


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


# ---------------------------------------------------------------------------
# phase 1: environment
# ---------------------------------------------------------------------------
def phase_env() -> dict:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA device")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"{src}/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    print(smi, flush=True)
    return {"smi": smi}


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------
def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, rec in logs.items():
        for line in rec["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version on the card
# ---------------------------------------------------------------------------
def _attn_case(B, S, T, H, KH, hd, dtype, *, seed, q_pos=None, kv_valid=None,
               packed=False, causal=True, window=0, softcap=0.0):
    """Inputs of one attention call.  q_pos: (B,) first query position of
    each row (decode: the cache index); kv_valid: (B,) last written cache
    position, later positions arrive as -1e9 like the serve path's
    masked cache tail."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn(B, S, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, T, KH, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, T, KH, hd, generator=g, device=dev).to(dtype)
    start = torch.zeros(B, dtype=torch.int32, device=dev) if q_pos is None \
        else torch.tensor(q_pos, dtype=torch.int32, device=dev)
    qp = start[:, None] + torch.arange(S, dtype=torch.int32, device=dev)
    kp = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    if kv_valid is not None:
        last = torch.tensor(kv_valid, dtype=torch.int32, device=dev)
        kp = torch.where(kp <= last[:, None], kp, -(10 ** 9))
    kw = dict(causal=causal, window=window, logit_softcap=softcap,
              q_positions=qp, kv_positions=kp.contiguous())
    if packed:  # two packed segments and a padding tail, S == T
        pad, cut = S // 8, (S - S // 8) // 2
        seg = torch.full((B, S), -1, dtype=torch.int32, device=dev)
        pos = torch.full((B, S), -(10 ** 9), dtype=torch.int32, device=dev)
        seg[:, :cut], seg[:, cut:S - pad] = 0, 1
        pos[:, :cut] = torch.arange(cut, device=dev, dtype=torch.int32)
        pos[:, cut:S - pad] = torch.arange(S - pad - cut, device=dev,
                                           dtype=torch.int32)
        kw.update(q_positions=pos, kv_positions=pos, q_segment_ids=seg,
                  kv_segment_ids=seg)
    return q, k, v, kw


# name -> (B, S, T, H, KH, hd, options); H 12 / KH 2 / hd 128 is qwen's
ATTN_CASES = {
    "prefill S=T causal": (2, 256, 256, 12, 2, 128, {}),
    "prefill over masked cache": (2, 100, 300, 12, 2, 128,
                                  {"kv_valid": [99, 99]}),
    "decode uniform index": (4, 1, 300, 12, 2, 128,
                             {"q_pos": [150] * 4, "kv_valid": [150] * 4}),
    "decode per-row index": (4, 1, 300, 12, 2, 128,
                             {"q_pos": [3, 77, 150, 299],
                              "kv_valid": [3, 77, 150, 299]}),
    "ragged S/T hd64": (1, 77, 131, 4, 2, 64, {"q_pos": [54]}),
    "window+softcap hd256": (2, 300, 300, 4, 2, 256,
                             {"window": 64, "softcap": 50.0}),
    "packed segments hd32": (2, 256, 256, 4, 1, 32, {"packed": True}),
    "serve prefill": (8, 512, 544, 12, 2, 128, {"kv_valid": [511] * 8}),
    "serve decode": (8, 1, 544, 12, 2, 128,
                     {"q_pos": [527] * 8, "kv_valid": [527] * 8}),
}


def _compare(out, ref, kw, dtype):
    from repro_torch.kernels.flash_attention import attn_mask

    mask = attn_mask(kw["q_positions"], kw["kv_positions"],
                     kw.get("q_segment_ids"), kw.get("kv_segment_ids"),
                     causal=kw["causal"], window=kw["window"])
    rows = mask.any(-1)  # (B, S): rows with at least one valid key
    o, r = out.float()[rows], ref.float()[rows]
    err = (o - r).abs()
    ok = bool(torch.isfinite(o).all()) and bool(
        (err <= TOL[dtype] * (1 + r.abs())).all())
    return ok, float(err.max()), int(rows.sum())


def phase_kernel_cases() -> dict:
    from repro_torch.kernels import flash_attention as fa

    errs = {}
    bad = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, (B, S, T, H, KH, hd, opt)) in enumerate(
                ATTN_CASES.items()):
            q, k, v, kw = _attn_case(B, S, T, H, KH, hd, dtype, seed=i, **opt)
            out = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            ref = fa.flash_attention_plain(q, k, v, **kw)
            ok, err, nrows = _compare(out, ref, kw, dtype)
            errs[(name, dtype)] = err
            tag = str(dtype).replace("torch.", "")
            log(f"flash_attention vs plain [{tag:8s}] {name:28s} "
                f"max|diff| {err:.3e} over {nrows} rows "
                f"(tol {TOL[dtype]:g}) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                bad.append(f"{name} {tag}")
    if bad:
        fail(f"flash_attention disagrees with its plain version: {bad}")
    return errs


# ---------------------------------------------------------------------------
# phase 3b: the flash gradient, kernel route against the plain route
# ---------------------------------------------------------------------------
# the masking cases of tests/test_torch_cuda.py, and the train path's call
TRAIN_ATTN = "train packed 4096"
GRAD_CASES = {
    "causal hd128": (2, 130, 130, 12, 2, 128, {}),
    "window hd64": (1, 45, 70, 4, 2, 64, {"window": 16, "q_pos": [25]}),
    "window+softcap hd256": (2, 64, 64, 4, 2, 256,
                             {"window": 24, "softcap": 50.0}),
    "non-causal hd32": (2, 33, 33, 4, 1, 32, {"causal": False}),
}


def _train_attn_case(seed, dtype=torch.float32):
    """One attention call of the train path: a 4096-token packed row of
    three LongAlign-like samples and a padding tail, laid out as
    ``data.packing.pack_sequences`` lays it out (positions restart per
    sample, padding is segment -1 at position 0), qwen's 12/2 heads."""
    from repro_torch.data.packing import pack_sequences
    import numpy as np

    S, H, KH, hd = TRAIN["max_tokens"], 12, 2, 128
    lens = (1500, 1800, 500)
    row = pack_sequences([np.zeros(n, np.int32) for n in lens], S)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(1, S, H, hd, generator=g, device="cuda").to(dtype)
    k = torch.randn(1, S, KH, hd, generator=g, device="cuda").to(dtype)
    v = torch.randn(1, S, KH, hd, generator=g, device="cuda").to(dtype)
    pos = torch.from_numpy(row["positions"])[None].cuda()
    seg = torch.from_numpy(row["segment_ids"])[None].cuda()
    kw = dict(causal=True, window=0, logit_softcap=0.0, q_positions=pos,
              kv_positions=pos, q_segment_ids=seg, kv_segment_ids=seg)
    return q, k, v, kw


def _grads(fn, q, k, v, kw, gout):
    """fn's output on (q, k, v), then dq, dk, dv for the cotangent gout."""
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v, **kw)
    out.backward(gout)
    return out.detach(), q.grad, k.grad, v.grad


def phase_flash_grad() -> dict:
    """Per case: (forward max|diff|, worst of dq/dk/dv max|diff|)."""
    from repro_torch.kernels import flash_attention as fa

    cases = {name: _attn_case(B, S, T, H, KH, hd, torch.float32, seed=i,
                              **opt)
             for i, (name, (B, S, T, H, KH, hd, opt))
             in enumerate(GRAD_CASES.items())}
    cases[TRAIN_ATTN] = _train_attn_case(seed=7)
    found = {}
    for name, (q, k, v, kw) in cases.items():
        gout = torch.randn(q.shape, device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(11))
        before = fa.launches
        out, *kern = _grads(fa.flash_attention, q, k, v, kw, gout)
        torch.cuda.synchronize()
        if fa.launches != before + 1:
            fail(f"flash gradient {name}: the kernel route did not launch "
                 f"the kernel")
        ref, *plain = _grads(fa.flash_attention_plain, q, k, v, kw, gout)
        fwd_ok, fwd_err, nrows = _compare(out, ref, kw, torch.float32)
        if not fwd_ok:
            fail(f"flash forward {name}: kernel and plain version disagree "
                 f"(max|diff| {fwd_err:.3e} over {nrows} rows)")
        errs = []
        for a, b in zip(kern, plain):
            err = (a - b).abs()
            ok = bool(torch.isfinite(a).all()) and bool(
                (err <= GRAD_TOL * (1 + b.abs())).all())
            errs.append(float(err.max()))
            if not ok:
                fail(f"flash gradient {name}: kernel route and plain route "
                     f"disagree (max|diff| {float(err.max()):.3e})")
        found[name] = (fwd_err, max(errs))
        log(f"flash gradient {name:22s} q {tuple(q.shape)}: max|diff| out "
            f"{fwd_err:.3e} over {nrows} rows (tol {TOL[torch.float32]:g}), "
            f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} "
            f"(tol {GRAD_TOL:g}) ok")
        del out, ref, kern, plain
    torch.cuda.empty_cache()
    return found


# ---------------------------------------------------------------------------
# phase 3c: the ODC ring kernels against the plain rings
# ---------------------------------------------------------------------------
def _ring_orders(n):
    """The natural ring and a DeviceProfile's ring order."""
    from repro_torch.balance.cost import make_straggler_profile
    from repro_torch.core import odc

    order = odc.ring_order(n, make_straggler_profile(
        "uniform", n, slow_factor=2.0, seed=0))
    if order is None:
        fail(f"the profile of {n} ranks orders its ring naturally")
    return [None, order]


def _scatter_bound(ys, n, c, dtype):
    """Elementwise bound on |ring - one library sum|: each sum rounds n-1
    times (in its own order), each rounding is at most one unit roundoff
    u of a partial sum, and every partial sum is at most the sum of |y|
    over the ranks; 2n instead of 2(n-1) covers the second-order terms."""
    u = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8}[dtype]
    return [2 * n * u * torch.stack([y[r * c:(r + 1) * c].float().abs()
                                     for y in ys]).sum(0)
            for r in range(n)]


def _ring_case(n, order, dtype, shape, g):
    from repro_torch.kernels import odc_gather as G
    from repro_torch.kernels import odc_scatter as S

    xs = [torch.randn(shape, generator=g, device="cuda").to(dtype)
          for _ in range(n)]
    out = G.odc_gather(xs, order)
    torch.cuda.synchronize()
    ref = G.odc_gather_plain(xs, order)
    gather_ok = all(torch.equal(a, b) for a, b in zip(out, ref))
    del xs, out, ref
    c = shape[0]
    ys = [torch.randn((n * c,) + tuple(shape[1:]), generator=g,
                      device="cuda").to(dtype) for _ in range(n)]
    out = S.odc_scatter_accumulate(ys, order)
    torch.cuda.synchronize()
    ref = S.odc_scatter_accumulate_plain(ys, order)
    scatter_ok = all(torch.equal(a, b) for a, b in zip(out, ref))
    lib = [torch.stack([y[r * c:(r + 1) * c] for y in ys]).sum(0)
           for r in range(n)]
    bound = _scatter_bound(ys, n, c, dtype)
    lib_ok = all(bool(((a.float() - b.float()).abs() <= e).all())
                 for a, b, e in zip(out, lib, bound))
    rel = max(float(((a.float() - b.float()).abs()
                     / (1 + b.float().abs())).max())
              for a, b in zip(out, lib))
    return gather_ok, scatter_ok, lib_ok, rel


def phase_rings() -> dict:
    g = torch.Generator(device="cuda").manual_seed(3)
    bad, worst_rel = [], {torch.float32: 0.0, torch.bfloat16: 0.0}
    bitwise = within = 0
    cases = [(n, order, dtype, (c,)) for n in RING_NS
             for order in _ring_orders(n)
             for dtype in (torch.float32, torch.bfloat16)
             for c in RING_SIZES]
    cases.append((2, None, torch.float32, W_UP_SHARD))
    for n, order, dtype, shape in cases:
        gok, sok, lok, rel = _ring_case(n, order, dtype, shape, g)
        worst_rel[dtype] = max(worst_rel[dtype], rel)
        bitwise += gok and sok
        within += lok
        tag = (f"n={n} order={order or 'natural'} "
               f"{str(dtype).replace('torch.', '')} shard {shape}")
        if not (gok and sok and lok):
            bad.append(f"{tag}: gather==plain {gok} scatter==plain {sok} "
                       f"scatter~sum {lok}")
    torch.cuda.empty_cache()
    log(f"ring kernels: {len(cases)} cases (n in {RING_NS}, natural and "
        f"profile-ordered rings, float32 and bfloat16, shards of "
        f"{RING_SIZES} elements and w_up's {W_UP_SHARD}): gather and "
        f"scatter bitwise equal to the plain rings in {bitwise}; scatter "
        f"vs torch.stack().sum(0) within 2n*u*sum|y| in {within}, max "
        f"|diff|/(1+|sum|) float32 "
        f"{worst_rel[torch.float32]:.2e} bfloat16 "
        f"{worst_rel[torch.bfloat16]:.2e}")
    if bad:
        fail("ring kernels disagree with the plain rings:\n  "
             + "\n  ".join(bad))
    return {"cases": len(cases), "rel": worst_rel}


def phase_ring_refusal():
    """A launch whose blocks cannot all be resident raises before it
    runs, and the card is usable after it."""
    from repro_torch.kernels import odc_gather as G

    xs = [torch.ones(4096, device="cuda") for _ in range(2)]
    before = G.launches
    try:
        G.odc_gather(xs, blocks_per_rank=1 << 20)
    except RuntimeError as e:
        log(f"ring refusal: {e}")
    else:
        fail("odc_gather launched a grid that cannot be co-resident")
    out = G.odc_gather(xs)
    torch.cuda.synchronize()
    if G.launches != before + 1 or not all(torch.equal(o, torch.ones(
            8192, device="cuda")) for o in out):
        fail("odc_gather after a refused launch is wrong")


# ---------------------------------------------------------------------------
# phase 4: serve qwen-1.5b at full width through the entry point, then
# the wave prefill with the plain attention, and a decode-step profile
# ---------------------------------------------------------------------------
def _serve_args(extra):
    from repro_torch.launch import serve

    return serve.parse_args(["--arch", ARCH, "--seed", str(SEED),
                             "--device", "cuda", "--dtype", "float32",
                             *extra])


def phase_serve() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import odc_gather as G
    from repro_torch.kernels import odc_scatter as S
    from repro_torch.launch import serve

    kernels = {"flash_attention": fa, "odc_gather": G,
               "odc_scatter_accumulate": S}

    results = {}
    runs = {
        "wave": ["--batch", str(WAVE["batch"]),
                 "--prompt-len", str(WAVE["prompt_len"]),
                 "--gen", str(WAVE["gen"])],
        "continuous": ["--continuous", "--slots", str(CONT["slots"]),
                       "--requests", str(CONT["requests"]),
                       "--length-spread", str(CONT["length_spread"]),
                       "--prompt-len", str(CONT["prompt_len"]),
                       "--gen", str(CONT["gen"])],
    }
    total = dict.fromkeys(kernels, 0)
    for mode, extra in runs.items():
        for mod in kernels.values():
            mod.launches = 0
        summary = serve.run(_serve_args(extra))
        torch.cuda.synchronize()
        got = {name: mod.launches for name, mod in kernels.items()}
        for name, count in got.items():
            total[name] += count
        n = got["flash_attention"]
        L = summary["num_layers"]
        want = L * (summary["prefill_calls"] + summary["decode_steps"])
        log(f"serve {mode}: prefill {summary['prefill_tok_s']:.1f} tok/s, "
            f"decode {summary['decode_tok_s']:.1f} tok/s, "
            f"flash_attention launches {n} (want {L} layers x "
            f"({summary['prefill_calls']} prefill calls + "
            f"{summary['decode_steps']} decode steps) = {want}), ring "
            f"launches {got['odc_gather']} + {got['odc_scatter_accumulate']}"
            f" (want 0), first ids {summary['first_ids'][:8]}")
        if n != want or n == 0:
            fail(f"{mode}: {n} kernel launches, want {want}")
        if got["odc_gather"] or got["odc_scatter_accumulate"]:
            fail(f"{mode}: serving launched a ring kernel")
        if not summary["ids_in_vocab"]:
            fail(f"{mode}: generated ids outside the vocabulary")
        results[mode] = summary
    results["launches"] = total

    # the wave prefill again, with the plain attention swapped in
    from repro_torch.models import layers

    args = _serve_args(["--batch", str(WAVE["batch"]),
                        "--prompt-len", str(WAVE["prompt_len"]),
                        "--gen", str(WAVE["gen"])])
    cfg, params, tokens = serve.build(args)
    engine = serve.make_engine(cfg, args)
    cache = engine.init_cache(tokens.shape[0], tokens.shape[1] + args.gen)
    batch = engine.prompt_batch(tokens)
    kern, _ = engine.prefill(params, batch, cache)
    prev = layers.set_attention_impl(fa.flash_attention_plain)
    try:
        cache = engine.init_cache(tokens.shape[0], tokens.shape[1] + args.gen)
        plain, _ = engine.prefill(params, batch, cache)
    finally:
        layers.set_attention_impl(prev)
    diff = float((kern[:, -1] - plain[:, -1]).abs().max())
    finite = bool(torch.isfinite(kern).all())
    log(f"wave prefill last-position logits {tuple(kern[:, -1].shape)}, "
        f"kernel vs plain attention max|diff| {diff:.3e} "
        f"(tol {LOGITS_TOL:g}), finite {finite}")
    if not finite or diff > LOGITS_TOL:
        fail("full-width prefill logits: kernel and plain attention "
             "disagree")
    results["logits_diff"] = diff
    tok = kern[:, -1].argmax(-1)[:, None]
    results["profile"] = _profile_decode(engine, params, cache, tok,
                                         tokens.shape[1])
    del params, engine, cache
    torch.cuda.empty_cache()
    return results


def _device_ms(prof, name, per, classes):
    """Device ms per kernel class (over ``per`` repetitions) from a
    torch.profiler trace: a kernel falls in the first class one of whose
    name fragments it contains, else in "other".  Kernels run one at a
    time on the one stream, so their durations add up to the busy time."""
    path = os.path.join(ROOT, "build", name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = {c: 0.0 for c in classes}
    dev["other"] = 0.0
    n_kernels = 0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        n_kernels += 1
        kname = e["name"].lower()
        cls = next((c for c, frags in classes.items()
                    if any(f in kname for f in frags)), "other")
        dev[cls] += e["dur"] / 1e3 / per
    return dev, n_kernels


def _profile_decode(engine, params, cache, tok, start, steps=8):
    """Where a steady-state wave decode step's time goes: host wall time
    per step without the profiler, then device time per kernel class from
    a torch.profiler trace of the same steps (kernels run one at a time on
    the one stream, so their durations add up to the busy time)."""
    from torch.profiler import ProfilerActivity, profile

    def run(first):
        nonlocal cache, tok
        for i in range(steps):
            logits, cache = engine.decode(params, cache, tok, first + i)
            tok = logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()

    run(start)  # warm: every decode shape has run once
    t0 = time.perf_counter()
    run(start + steps)
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(start + 2 * steps)
        wall_prof = (time.perf_counter() - t0) * 1e3 / steps
    dev, n_kernels = _device_ms(prof, "decode_trace.json", steps, {
        "flash_attention": ("attn_fwd",), "gemm": ("gemm", "gemv")})
    busy = sum(dev.values())
    log(f"decode step profile (wave, batch {tok.shape[0]}): host "
        f"{wall:.2f} ms/step ({wall_prof:.2f} under the profiler), device "
        f"busy {busy:.2f} ms/step = flash_attention {dev['flash_attention']:.2f}"
        f" + gemm {dev['gemm']:.2f} + other {dev['other']:.2f}, "
        f"{n_kernels / steps:.0f} kernels/step, device idle "
        f"{max(0.0, 1 - busy / wall):.1%} of the step")
    if busy <= 0:
        log("decode step profile: the trace holds no device time "
            "(device breakdown not measured)")
    return {"host_ms": wall, "device_ms": dev,
            "kernels_per_step": n_kernels / steps}


# ---------------------------------------------------------------------------
# phase 4b: train qwen-1.5b at full width with two ranks on the card
# ---------------------------------------------------------------------------
def _expected_launches(cfg, comm, schedule, summary, dims):
    """Kernel launches a train run must make, from the model's leaves and
    layers and the run's microbatches and steps.  Every layer runs its
    attention twice per microbatch (forward, and the recompute of the
    backward pass); one ring launch serves every rank."""
    from repro_torch.core import fsdp

    L = cfg.num_layers
    sharded = [p for p in fsdp.tree_paths(dims)
               if fsdp.get(dims, p) is not None]
    top = [p for p in sharded if p[0] != fsdp.STACK_KEY]
    per_layer = len(sharded) - len(top)
    want = {"flash_attention": 0, "odc_gather": 0,
            "odc_scatter_accumulate": 0}
    ring = comm == "odc"
    for st in summary["steps"]:
        if schedule == "minibatch":
            # each rank runs only its real microbatches; every leaf is
            # gathered once and scattered once per step
            want["flash_attention"] += 2 * L * sum(st["counts"])
            want["odc_gather"] += len(sharded) * ring
            want["odc_scatter_accumulate"] += len(sharded) * ring
        else:
            # microbatch j of every rank in lockstep, padded to M; the
            # top-level leaves once per microbatch, each layer's leaves in
            # the forward and again in the recompute
            M = st["microbatches"]
            want["flash_attention"] += 2 * L * summary["world"] * M
            want["odc_gather"] += M * (len(top) + 2 * L * per_layer) * ring
            want["odc_scatter_accumulate"] += \
                M * (len(top) + L * per_layer) * ring
    return want


def _profile_train_step() -> dict:
    """Where one ODC x minibatch train step's time goes: host wall time of
    a step without the profiler, then device time per kernel class from a
    torch.profiler trace of the same step (same batch, next parameters)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.balance.cost import CostModel
    from repro_torch.configs import get_config
    from repro_torch.core.ranks import RankGroup
    from repro_torch.core.train_step import Trainer
    from repro_torch.data.loader import SyntheticSFTLoader
    from repro_torch.data.packing import build_minibatch
    from repro_torch.models import transformer as T

    cfg = get_config(ARCH)
    ranks = RankGroup.make(TRAIN["data_axis"], "cuda")
    tr = Trainer(cfg, ranks, comm="odc", schedule="minibatch")
    shards, opt = tr.init_state(T.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED)))
    loader = SyntheticSFTLoader(
        "longalign", vocab_size=cfg.vocab_size, world_size=ranks.n,
        minibatch_per_device=TRAIN["minibatch_per_device"],
        max_tokens=TRAIN["max_tokens"], strategy="lb_mini",
        max_len=TRAIN["max_len"], seed=SEED,
        cost_model=CostModel(attention_free=cfg.is_attention_free,
                             window=cfg.sliding_window))
    sd = next(loader.steps(1))
    batch = build_minibatch(sd["plan"], sd["sample_tokens"],
                            TRAIN["max_tokens"])
    counts = [len(a) for a in sd["plan"].assignments]

    def step():
        nonlocal shards, opt
        shards, opt, m = tr.step(shards, opt, batch, counts)
        torch.cuda.synchronize()
        return float(m["tokens"])

    t0 = time.perf_counter()
    tokens = step()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall_prof = (time.perf_counter() - t0) * 1e3
    dev, n_kernels = _device_ms(prof, "train_trace.json", 1, {
        "flash_attention": ("attn_fwd",),
        "odc_rings": ("odc_gather_kernel", "odc_scatter_kernel"),
        "gemm": ("gemm", "gemv", "cutlass", "xmma")})
    busy = sum(dev.values())
    log(f"train step profile (odc x minibatch, step 0's batch, "
        f"{tokens:.0f} tokens, microbatches {counts}): host {wall:.1f} ms "
        f"({wall_prof:.1f} under the profiler), device busy {busy:.1f} ms "
        f"= " + " + ".join(f"{k} {v:.1f}" for k, v in dev.items())
        + f", {n_kernels} kernels, device idle "
        f"{max(0.0, 1 - busy / wall):.1%} of the step")
    if busy <= 0:
        fail("train step profile: the trace holds no device time")
    del shards, opt, tr
    return {"host_ms": wall, "device_ms": dev, "kernels": n_kernels}


def phase_train() -> dict:
    import gc
    from repro_torch.core import fsdp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import odc_gather as G
    from repro_torch.kernels import odc_scatter as S
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    kernels = {"flash_attention": fa, "odc_gather": G,
               "odc_scatter_accumulate": S}
    runs = {}
    for comm, schedule in TRAIN_CONFIGS:
        args = train.parse_args([
            "--arch", ARCH, "--seed", str(SEED), "--device", "cuda",
            "--comm", comm, "--schedule", schedule, "--strategy", "lb_mini",
            "--dataset", "longalign",
            "--data-axis", str(TRAIN["data_axis"]),
            "--steps", str(TRAIN["steps"]),
            "--max-tokens", str(TRAIN["max_tokens"]),
            "--max-len", str(TRAIN["max_len"]),
            "--minibatch-per-device", str(TRAIN["minibatch_per_device"])])
        torch.cuda.reset_peak_memory_stats()
        for mod in kernels.values():
            mod.launches = 0
        summary = train.run(args)
        torch.cuda.synchronize()
        got = {name: mod.launches for name, mod in kernels.items()}
        cfg = get_config(ARCH)
        dims = summary["dims"]
        if any(fsdp.get(dims, p) is None for p in fsdp.tree_paths(dims)):
            fail(f"{ARCH} on {TRAIN['data_axis']} ranks replicates a leaf")
        want = _expected_launches(cfg, comm, schedule, summary, dims)
        peak = torch.cuda.max_memory_allocated()
        tag = f"{comm} x {schedule}"
        log(f"train {tag}: losses {summary['losses']}, step s "
            f"{[round(t, 3) for t in summary['step_s']]}, tokens "
            f"{[st['tokens'] for st in summary['steps']]}, microbatches "
            f"{[(st['microbatches'], st['counts']) for st in summary['steps']]}"
            f", {summary['tok_s']:.1f} tok/s, peak memory "
            f"{peak / 2 ** 30:.2f} GiB, launches {got} (want {want})")
        if not all(math.isfinite(x) for x in summary["losses"]):
            fail(f"train {tag}: a loss is not finite")
        if got != want:
            fail(f"train {tag}: kernel launches {got}, want {want}")
        summary["peak_bytes"] = peak
        summary["launches"] = got
        runs[tag] = summary
        gc.collect()
        torch.cuda.empty_cache()
    (a, ra), (b, rb) = runs.items()
    l0a, l0b = ra["losses"][0], rb["losses"][0]
    if l0a != l0b:
        fail(f"train step-0 losses differ: {a} {l0a!r}, {b} {l0b!r} (the "
             f"same parameters and batches through the same forward)")
    gna, gnb = (r["steps"][0]["grad_norm"] for r in (ra, rb))
    gn_rel = abs(gna - gnb) / gnb
    rel = max(abs(x - y) / abs(y) for x, y in zip(ra["losses"][1:],
                                                   rb["losses"][1:]))
    log(f"train: step-0 losses equal ({l0a!r}); step-0 gradient norms "
        f"{a} {gna!r}, {b} {gnb!r}, {gn_rel:.2e} relative (tol "
        f"{GRAD_NORM_RTOL:g}); later losses agree to {rel:.2e} relative "
        f"(tol {TRAIN_LOSS_RTOL:g})")
    if not math.isfinite(gna) or gn_rel > GRAD_NORM_RTOL:
        fail(f"train: {a} and {b} step-0 gradient norms differ by "
             f"{gn_rel:.2e}")
    if rel > TRAIN_LOSS_RTOL:
        fail(f"train: {a} and {b} losses after step 0 differ by {rel:.2e}")
    gc.collect()
    torch.cuda.empty_cache()
    _profile_train_step()
    gc.collect()
    torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------------------
# phase 5: times against bounds
# ---------------------------------------------------------------------------
def _time_ms(fn, iters=20, warmup=3):
    """Mean device time of one call, with L2 flushed before each call: in
    the serve path a layer's K/V was last touched a whole model ago."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def _attn_bound(q, k, kw):
    """Least time for the work this input needs: every unmasked
    (query, key, head) triple costs 4*hd operations (QK^T and PV), and
    the bytes are q and out once each plus K/V of the unmasked cache
    prefix of each row, plus the int32 positions."""
    from repro_torch.kernels.flash_attention import attn_mask

    B, S, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    es = q.element_size()
    mask = attn_mask(kw["q_positions"], kw["kv_positions"],
                     kw.get("q_segment_ids"), kw.get("kv_segment_ids"),
                     causal=kw["causal"], window=kw["window"])
    pairs = int(mask.sum())
    ops = 4 * hd * H * pairs
    kv_rows = int(mask.any(1).sum())  # cache positions some query needs
    nbytes = 2 * B * S * H * hd * es + 2 * kv_rows * KH * hd * es \
        + 4 * B * (S + T)
    t_ops = ops / PEAK_FLOPS[q.dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _sdpa(q, k, v, kw):
    """One library call for the same function: SDPA with the boolean mask
    and GQA, timed as a yardstick only (the port never calls it)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attn_mask

    mask = attn_mask(kw["q_positions"], kw["kv_positions"],
                     kw.get("q_segment_ids"), kw.get("kv_segment_ids"),
                     causal=kw["causal"], window=kw["window"])[:, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def _ring_times(kind, n, shape) -> dict:
    """Kernel, plain ring and library times of one ring kernel on n ranks'
    float32 shards of ``shape`` (bound: n*c read + n^2*c written for the
    gather, n^2*c read + n*c written for the scatter, at 3.35 TB/s), and
    the kernel's max |diff| from the plain ring there."""
    from repro_torch.kernels import odc_gather as G
    from repro_torch.kernels import odc_scatter as S

    g = torch.Generator(device="cuda").manual_seed(5)
    numel = math.prod(shape)
    c_bytes = numel * 4
    if kind == "gather":
        xs = [torch.randn(shape, generator=g, device="cuda")
              for _ in range(n)]
        max_err = max(float((a - b).abs().max()) for a, b in zip(
            G.odc_gather(xs), G.odc_gather_plain(xs)))
        ms = _time_ms(lambda: G.odc_gather(xs), iters=10)
        plain_ms = _time_ms(lambda: G.odc_gather_plain(xs), iters=10)
        lib_ms = _time_ms(lambda: [torch.cat(xs) for _ in range(n)],
                          iters=10)
        nbytes = (n + n * n) * c_bytes
    else:
        ys = [torch.randn((n * shape[0],) + tuple(shape[1:]), generator=g,
                          device="cuda") for _ in range(n)]
        stacked = torch.stack(ys).view((n, n) + tuple(shape))
        max_err = max(float((a - b).abs().max()) for a, b in zip(
            S.odc_scatter_accumulate(ys), S.odc_scatter_accumulate_plain(ys)))
        ms = _time_ms(lambda: S.odc_scatter_accumulate(ys), iters=10)
        plain_ms = _time_ms(lambda: S.odc_scatter_accumulate_plain(ys),
                            iters=10)
        lib_ms = _time_ms(lambda: [stacked[:, r].sum(0) for r in range(n)],
                          iters=10)
        nbytes = (n * n + n) * c_bytes
    bound_ms = nbytes / PEAK_BYTES * 1e3
    name = "odc_gather" if kind == "gather" else "odc_scatter_accumulate"
    shape_s = f"n={n} float32 shard {shape} ({c_bytes / 2 ** 20:.1f} MiB)"
    log(f"time {name} {shape_s}: kernel {ms:.4f} ms, bound {bound_ms:.4f} "
        f"ms (bytes), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
        f"kernel/bound {ms / bound_ms:.1f}x")
    torch.cuda.empty_cache()
    return {"shape": shape_s, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": lib_ms}


def phase_times(errs, grad_errs, serve_launches, train_runs) -> list:
    """One record per kernel: its numbers at the first shape, and at each
    measured shape under ``per_shape``; launches over the serve and train
    runs, by path under ``launches_by_path``."""
    from repro_torch.kernels import flash_attention as fa

    by_path = {}
    for name in ("flash_attention", "odc_gather", "odc_scatter_accumulate"):
        by_path[name] = {"serve": serve_launches[name]}
        for tag, run in train_runs.items():
            by_path[name][f"train {tag}"] = run["launches"][name]

    shapes = []
    for name in ("serve prefill", "serve decode", "train"):
        if name == "train":
            q, k, v, kw = _train_attn_case(seed=99)
            shape = (f"train: packed q {tuple(q.shape)} kv {tuple(k.shape)} "
                     f"float32, segments of 1500/1800/500 + padding")
            err, grad_err = grad_errs[TRAIN_ATTN]
        else:
            B, S, T, H, KH, hd, opt = ATTN_CASES[name]
            q, k, v, kw = _attn_case(B, S, T, H, KH, hd, torch.float32,
                                     seed=99, **opt)
            shape = (f"{name}: q {tuple(q.shape)} kv {tuple(k.shape)} "
                     f"float32, cache valid to {opt['kv_valid'][0]}")
            err = errs[(name, torch.float32)]
        ms = _time_ms(lambda: fa.flash_attention(q, k, v, **kw))
        plain_ms = _time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw))
        lib_ms = _time_ms(_sdpa(q, k, v, kw))
        bound_ms, bound_by = _attn_bound(q, k, kw)
        log(f"time flash_attention {shape}: kernel {ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, kernel/bound {ms / bound_ms:.1f}x")
        shapes.append({"shape": shape, "max_abs_err": err,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": lib_ms})
        if name == "train":  # dq/dk/dv of the kernel route vs the plain
            shapes[-1]["grad_max_abs_err"] = grad_err
        del q, k, v
    records = [{"name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:167",
                "launches": sum(by_path["flash_attention"].values()),
                "launches_by_path": by_path["flash_attention"],
                **shapes[0], "per_shape": shapes}]
    for kind, name, src, replaces in (
            ("gather", "odc_gather", "odc_gather.cu",
             "src/repro/kernels/odc_gather.py:103"),
            ("scatter", "odc_scatter_accumulate", "odc_scatter.cu",
             "src/repro/kernels/odc_scatter.py:89")):
        ring = [_ring_times(kind, 2, W_UP_SHARD),
                _ring_times(kind, 4, (2 ** 24,))]
        records.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{src}",
                        "replaces": replaces,
                        "launches": sum(by_path[name].values()),
                        "launches_by_path": by_path[name], **ring[0],
                        "per_shape": ring})
    return records


def main() -> int:
    t0 = time.perf_counter()
    env = phase_env()
    phase_build()
    errs = phase_kernel_cases()
    grad_errs = phase_flash_grad()
    phase_rings()
    phase_ring_refusal()
    served = phase_serve()
    trained = phase_train()
    records = phase_times(errs, grad_errs, served["launches"], trained)
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s")
    print(env["smi"])
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
