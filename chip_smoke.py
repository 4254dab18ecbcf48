"""Chip smoke test of the PyTorch/CUDA port: builds the port's kernels,
holds each one to its plain PyTorch version on the card, serves
full-width qwen-1.5b through the serve entry point in both modes, and
times each kernel against its bound and its library yardstick.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It exits non-zero, printing no result, when there is no CUDA device or the
repository's ``src/`` is not beside it.  The last line of its output is
``{"ok": true, "device": {...}}``, printed only when every phase passed;
the line before it is the kernels' JSON record.
"""
from __future__ import annotations

import json
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

# The serve runs: qwen-1.5b at its published widths, fp32, one card.
ARCH = "qwen-1.5b"
WAVE = dict(batch=8, prompt_len=512, gen=32)
CONT = dict(slots=4, requests=12, length_spread=4.0, prompt_len=512, gen=32)
SEED = 0


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
    from repro_torch.launch import serve

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
    total = 0
    for mode, extra in runs.items():
        fa.launches = 0
        summary = serve.run(_serve_args(extra))
        torch.cuda.synchronize()
        n = fa.launches
        total += n
        L = summary["num_layers"]
        want = L * (summary["prefill_calls"] + summary["decode_steps"])
        log(f"serve {mode}: prefill {summary['prefill_tok_s']:.1f} tok/s, "
            f"decode {summary['decode_tok_s']:.1f} tok/s, "
            f"flash_attention launches {n} (want {L} layers x "
            f"({summary['prefill_calls']} prefill calls + "
            f"{summary['decode_steps']} decode steps) = {want}), "
            f"first ids {summary['first_ids'][:8]}")
        if n != want or n == 0:
            fail(f"{mode}: {n} kernel launches, want {want}")
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
    path = os.path.join(ROOT, "build", "decode_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = {"flash_attention": 0.0, "gemm": 0.0, "other": 0.0}
    n_kernels = 0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        n_kernels += 1
        name = e["name"].lower()
        cls = ("flash_attention" if "attn_fwd" in name else
               "gemm" if "gemm" in name or "gemv" in name else "other")
        dev[cls] += e["dur"] / 1e3 / steps
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


def phase_times(errs, launches) -> list:
    """One record per kernel: its numbers at the serve path's prefill
    shape, and at each of the path's shapes under ``per_shape``."""
    from repro_torch.kernels import flash_attention as fa

    shapes = []
    for name in ("serve prefill", "serve decode"):
        B, S, T, H, KH, hd, opt = ATTN_CASES[name]
        q, k, v, kw = _attn_case(B, S, T, H, KH, hd, torch.float32, seed=99,
                                 **opt)
        ms = _time_ms(lambda: fa.flash_attention(q, k, v, **kw))
        plain_ms = _time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw))
        lib_ms = _time_ms(_sdpa(q, k, v, kw))
        bound_ms, bound_by = _attn_bound(q, k, kw)
        shape = (f"{name}: q {tuple(q.shape)} kv {tuple(k.shape)} float32, "
                 f"cache valid to {opt['kv_valid'][0]}")
        log(f"time flash_attention {shape}: kernel {ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, kernel/bound {ms / bound_ms:.1f}x")
        shapes.append({"shape": shape,
                       "max_abs_err": errs[(name, torch.float32)],
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": lib_ms})
    return [{"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:167",
             "launches": launches, **shapes[0], "per_shape": shapes}]


def main() -> int:
    t0 = time.perf_counter()
    env = phase_env()
    phase_build()
    errs = phase_kernel_cases()
    served = phase_serve()
    records = phase_times(errs, served["launches"])
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s")
    print(env["smi"])
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
