"""Serving driver on one card: wave-at-a-time or continuous (in-flight)
batching, the PyTorch counterpart of ``repro.launch.serve``.

Default mode prefills one fixed request batch and decodes it in lockstep
(``GenerationEngine``).  ``--continuous`` routes the requests through the
``ContinuousGenerationEngine`` instead: a request queue feeds ``--slots``
decode lanes through the block allocator, short requests retire early
(``--length-spread`` carves per-request lengths), and freed slots admit
queued requests mid-decode.  Every attention call goes through the
hand-written CUDA kernel (``repro_torch.kernels.flash_attention``).  The
ssm family (``--arch mamba2-2.7b``) serves in wave mode only: its prefill
runs the hand-written SSD scan kernel (``repro_torch.kernels.ssd_scan``)
and writes each layer's conv tail and final scan state into a new cache,
and each decode step is the recurrent update; ``--continuous`` refuses
it, as the JAX engine does.  So does the hybrid family (``--arch
zamba2-1.2b``): its prefill runs the scan kernel in every mamba block and
the flash kernel in each invocation of the shared attention block, whose
KV cache is one per invocation.  The moe family (``--arch grok-1-314b``,
``llama4-maverick-400b-a17b``) serves in wave mode: attention through the
flash kernel, the routed experts as batched products, and a per-row tally
of tokens per expert carried in the cache so that each decode step drops
what the full forward would; llama4's prompt batch carries the vision
stub's patch embeddings (``vision_embeds``, drawn from ``--seed``, over
the first min(frontend_tokens, prompt) positions), as the JAX driver's
does.  The vlm family (``--arch chameleon-34b``) is the dense trunk.
The audio family (``--arch seamless-m4t-medium``) serves in wave mode: the
prefill encodes the stub frontend's frame embeddings (``encoder_embeds``,
(batch, prompt, d), drawn from ``--seed``, as the JAX driver's) and keeps
the encoder output in the cache, and each decode step cross-attends to
it; every self-, encoder and cross-attention call goes through the flash
kernel.

``--metrics m.jsonl`` writes one snapshot of the engine counters and the
throughput gauges (``serve.*``, and in continuous mode ``engine.*``) as
JSONL; ``--trace t.json`` (continuous mode, as in the JAX driver) writes
the engine's per-slot scheduled timeline as a Chrome trace.

Weights are random, drawn from ``--seed`` by a ``torch.Generator`` on the
target device.  Runs on the card unless ``--device cpu`` is given;
float32 matrix products run in full f32 (TF32 off).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen-1.5b \\
      --batch 8 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen-1.5b \\
      --continuous --slots 4 --requests 12 --length-spread 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen-1.5b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen-1.5b \\
      --reduced --device cpu --continuous --trace t.json --metrics m.jsonl
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
      --batch 8 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch grok-1-314b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch seamless-m4t-medium --reduced --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.models import transformer as T
from repro_torch.obs import log as obs_log
from repro_torch.obs import metrics as obs_metrics
from repro_torch.posttrain.engine import (
    ContinuousGenerationEngine, GenerationEngine,
)
from repro_torch.sim.trace import TraceRecorder

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _request_lengths(n: int, gen: int, spread: float, seed: int):
    """Per-request generated-token counts in [gen/spread, gen], seeded:
    the mixed-length stream continuous batching exists for."""
    rng = np.random.RandomState(seed)
    lo = max(1, int(round(gen / max(spread, 1.0))))
    return rng.randint(lo, gen + 1, size=n)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--data-axis", type=int, default=0,
                    help="one card: 0 or 1 (no mesh in this port yet)")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="one card: 1 (no tensor parallelism yet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="in-flight batching: a request queue over --slots "
                         "decode lanes with block-allocated KV; short "
                         "requests retire early and queued ones join "
                         "mid-decode (the dense family only: the vlm, moe, "
                         "ssm, hybrid and audio families serve in wave "
                         "mode)")
    ap.add_argument("--slots", type=int, default=4,
                    help="continuous: decode lanes (the decode batch width)")
    ap.add_argument("--requests", type=int, default=12,
                    help="continuous: queued request count")
    ap.add_argument("--length-spread", type=float, default=4.0,
                    help="continuous: max/min generated-length ratio of the "
                         "request stream")
    ap.add_argument("--block-size", type=int, default=16,
                    help="continuous: KV-block granularity (positions)")
    ap.add_argument("--trace", default="",
                    help="continuous: write the per-slot scheduled timeline "
                         "as a Chrome trace JSON")
    ap.add_argument("--metrics", default="",
                    help="write a metrics snapshot (engine counters, "
                         "throughput gauges) as JSONL")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="float32")
    obs_log.add_log_args(ap)
    args = ap.parse_args(argv)
    if args.data_axis not in (0, 1) or args.model_axis != 1:
        ap.error("repro_torch serves on one card: --data-axis 0|1 and "
                 "--model-axis 1 only")
    return args


def _device(args) -> torch.device:
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch finds no CUDA device; "
                           "pass --device cpu to run on the CPU")
    return torch.device(args.device)


def build(args, cfg=None):
    """(cfg, params, prompt tokens) of a run: random weights and prompts
    from ``--seed``, drawn on the target device.  ``cfg``: a model
    configuration to serve in place of ``--arch``'s (a full-width model
    cut in depth, for one)."""
    device = _device(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg is None:
        cfg = get_reduced(args.arch) if args.reduced \
            else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init_params(cfg, gen, DTYPES[args.dtype])
    n = args.requests if args.continuous else args.batch
    tokens = torch.randint(1, cfg.vocab_size, (n, args.prompt_len),
                           generator=gen, device=device)
    return cfg, params, tokens


def stub_extras(cfg, args, B: int, S: int):
    """The stub frontend's prefill entries of a (B, S) prompt batch
    (``repro.launch.serve``'s), drawn from ``--seed``: for the audio
    family, (B, S, d) frame embeddings; for a vision frontend, (B, min(
    frontend_tokens, S), d) patch embeddings; else None."""
    if cfg.family == "audio":
        key, n = "encoder_embeds", S
    elif cfg.frontend == "vision" and cfg.frontend_tokens:
        key, n = "vision_embeds", min(cfg.frontend_tokens, S)
    else:
        return None
    device = _device(args)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    x = torch.randn((B, n, cfg.d_model), generator=gen, device=device)
    return {key: x.to(DTYPES[args.dtype])}


def make_engine(cfg, args) -> GenerationEngine:
    return GenerationEngine(cfg, device=_device(args),
                            dtype=DTYPES[args.dtype])


def _serve_continuous(cfg, params, tokens, args, out, reg) -> dict:
    S, G = args.prompt_len, args.gen
    rec = None
    if args.trace:
        rec = TraceRecorder(meta={"driver": "launch.serve", "arch": cfg.name,
                                  "mode": "continuous", "slots": args.slots,
                                  "clock": "scheduled"})
    engine = ContinuousGenerationEngine(
        cfg, slots=args.slots, max_len=S + G, block_size=args.block_size,
        device=_device(args), dtype=DTYPES[args.dtype], trace=rec)
    engine.publish(params, 0)
    lens = _request_lengths(args.requests, G, args.length_spread, args.seed)
    prompts = tokens.cpu().numpy()
    for b in range(args.requests):
        engine.submit(prompts[b], int(lens[b]))
    done = engine.run()
    total = int(sum(len(c.generated) for c in done))
    prefill_tok_s = args.requests * S / max(engine.prefill_s, 1e-9)
    decode_tok_s = engine.decoded_tokens / max(engine.decode_s, 1e-9)
    out.info(f"continuous: {len(done)} requests "
             f"({total} generated tokens) over {args.slots} slots in "
             f"{engine.steps} decode steps")
    out.info(f"prefill {engine.prefills} x {S} tokens in "
             f"{engine.prefill_s:.2f}s ({prefill_tok_s:.0f} tok/s); decoded "
             f"{engine.decoded_tokens} tokens in {engine.decode_s:.2f}s "
             f"({decode_tok_s:.1f} tok/s)")
    out.info(f"kv blocks: {engine.allocator.num_blocks} x "
             f"{engine.allocator.block_size} positions, all freed: "
             f"{engine.allocator.free_blocks == engine.allocator.num_blocks}")
    by_rid = {c.rid: c for c in done}
    first = by_rid.get(0)
    first_ids = [] if first is None else first.generated[:16].tolist()
    if first is not None:  # --requests 0: nothing was admitted or decoded
        out.info(f"req 0: {len(first.generated)} tokens "
                 f"(weights v{first.weight_version}, {first.finish_reason}) "
                 f"ids: {first_ids}")
    ids = np.concatenate([c.generated for c in done]) if done else \
        np.zeros(0, np.int32)
    if reg is not None:
        reg.gauge("serve.requests_done").set(float(len(done)))
        reg.gauge("serve.generated_tokens").set(float(total))
        reg.gauge("serve.decode_steps").set(float(engine.steps))
        reg.step(0)
    if rec is not None:
        out.always(f"wrote per-slot trace {rec.write(args.trace)}")
    return {"mode": "continuous", "num_layers": cfg.num_layers,
            "prefill_calls": engine.prefills, "decode_steps": engine.steps,
            "prefill_tok_s": prefill_tok_s, "decode_tok_s": decode_tok_s,
            "generated_tokens": total, "first_ids": first_ids,
            "ids_in_vocab": bool(((ids >= 0) & (ids < cfg.vocab_size)).all())}


def run(args, cfg=None) -> dict:
    """Serve one run as the flags say; returns its summary.  ``cfg``: as
    for ``build``."""
    out = obs_log.from_args("serve", args)
    cfg, params, tokens = build(args, cfg)
    mode = "continuous" if args.continuous else "wave"
    out.info(f"{cfg.name} device={args.device} dtype={args.dtype} "
             f"mode={mode} prompt={args.prompt_len} gen={args.gen}")
    reg = None
    if args.metrics:
        reg = obs_metrics.MetricsRegistry(meta={
            "driver": "launch.serve", "arch": cfg.name, "mode": mode,
            "slots": args.slots, "source": "real"})
        reg.attach_jsonl(args.metrics)
        obs_metrics.set_active(reg)
    try:
        if args.continuous:
            return _serve_continuous(cfg, params, tokens, args, out, reg)
        return _serve_wave(cfg, params, tokens, args, out, reg)
    finally:
        if reg is not None:
            obs_metrics.set_active(None)
            reg.close()
            out.always(f"wrote metrics {args.metrics}")


def _serve_wave(cfg, params, tokens, args, out, reg) -> dict:
    B, S = tokens.shape
    res = make_engine(cfg, args).generate(
        params, tokens, args.gen, batch_extras=stub_extras(cfg, args, B, S))
    prefill_tok_s = B * S / max(res.prefill_s, 1e-9)
    decode_tok_s = B * (args.gen - 1) / max(res.decode_s, 1e-9)
    out.info(f"prefill {B}x{S} in {res.prefill_s:.2f}s "
             f"({prefill_tok_s:.0f} tok/s)")
    out.info(f"decoded {args.gen - 1} steps x {B} requests in "
             f"{res.decode_s:.2f}s ({decode_tok_s:.1f} tok/s)")
    out.info(f"sample output ids: {res.generated[0, :16].tolist()}")
    ids = res.generated
    if reg is not None:
        reg.gauge("serve.prefill_s").set(res.prefill_s)
        reg.gauge("serve.decode_s").set(res.decode_s)
        reg.gauge("serve.generated_tokens").set(float(B * (args.gen - 1)))
        reg.step(0)
    return {"mode": "wave", "num_layers": cfg.num_layers,
            "prefill_calls": 1, "decode_steps": args.gen - 1,
            "prefill_tok_s": prefill_tok_s, "decode_tok_s": decode_tok_s,
            "generated_tokens": int(ids.size),
            "first_ids": ids[0, :16].tolist(), "generated": ids,
            "ids_in_vocab": bool(((ids >= 0) & (ids < cfg.vocab_size)).all())}


def main(argv=None):
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
