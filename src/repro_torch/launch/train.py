"""SFT training driver, the PyTorch counterpart of ``repro.launch.train``.

Synthetic length-realistic data -> a load-balancing strategy (LocalSort /
LB-Micro / LB-Mini) -> sequence packing -> the FSDP train step over the
ranks of a ``RankGroup`` (``--comm odc --schedule minibatch``, the
paper's ODC; ``--comm collective --schedule layer``, the FSDP baseline;
``--comm odc-overlap``, or ``--schedule overlap``, the prefetch schedule;
``--comm cp --cp N``, context parallelism: data x N ranks in ring groups of
N that sequence-shard their rows and attend through ring attention over
the hand-written state-sweep kernel, best with ``--strategy lb_token``;
``--comm hier --nodes N``, two-tier ODC over N nodes of world / N ranks;
``--comm pipe`` / ``pipe-int8 --pipe-stages S``, the same two tiers as S
stages under the 1F1B schedule, pipe-int8 with the inter tier on the
chunked int8 wire) -> sharded AdamW -> checkpoints (``--ckpt-dir``, ``--save-every``,
``--resume``).  One process holds every rank; on one card every rank lies
on it, so ``--data-axis 2`` trains with two ranks on one H100 and each
ODC ring is one launch of a hand-written CUDA kernel (under the overlap
schedule, one chained launch per microbatch round carries the whole
trunk).

The dense family trains under every ``--comm``.  The ssm family
(``--arch mamba2-2.7b``, whose mixers run the hand-written SSD scan
kernel) and the hybrid family (``--arch zamba2-1.2b``: super-layers of
mamba blocks, each followed by one shared attention block through the
flash kernel) train under collective, odc, odc-overlap, hier, pipe and
pipe-int8, and refuse cp (ROADMAP.md queue 1 item 5).  Under the overlap
schedule the hybrid's chained rings carry one super-layer a ring "layer";
the tail and the shared block move through the single-leaf rings.  The moe
family (``--arch grok-1-314b``, ``llama4-maverick-400b-a17b``: super-layers
of P-1 dense blocks and one moe block, top-k routing with capacity, the
router's aux loss in the loss) trains under collective, odc and
odc-overlap (one super-layer a chained ring "layer"), and refuses cp and
the two-tier backends (ROADMAP.md queue 1 item 12); each step's batch
carries the vision stub's patch embeddings for llama4 (``vision_embeds``,
drawn per step from ``numpy.random.RandomState(step)``, as the JAX
driver draws them).  The vlm family (``--arch chameleon-34b``) trains
wherever the dense family does.  The audio family (``--arch
seamless-m4t-medium``: an encoder-decoder, the encoder's layers over the
stub frontend's frame embeddings and the decoder's cross-attending to
them) trains under collective, odc and odc-overlap (two chained trunks,
the encoder's and the decoder's) and refuses cp and the two-tier
backends (ROADMAP.md queue 1 item 14); each step's batch carries 16
frames a microbatch row (``encoder_embeds``, drawn per step from
``numpy.random.RandomState(step)``, as the JAX driver draws them).
Weights are random, drawn from
``--seed`` by a ``torch.Generator`` on the target device, in float32;
float32 products run in full f32 (TF32 off).
Runs on the card unless ``--device cpu`` is given.  ``--trace t.json``
writes each step's wall-clock host and trainer spans (the trainer's ends
after the device has finished the step) as a Chrome trace;
``--metrics m.jsonl`` writes one snapshot a step: the ``train.*`` gauges
and counters and the ``comm.*`` counters and message-size histograms per
backend, op and tier, counted site by site as the JAX driver's file
counts them (``core.backend.record_step``).  ``--config`` (the tuner's
result file) is not yet ported (ROADMAP.md queue 1 item 8).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen-1.5b \\
      --data-axis 2 --steps 3 --max-tokens 4096 --max-len 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen-1.5b \\
      --reduced --device cpu --data-axis 2 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen-1.5b \\
      --reduced --device cpu --data-axis 2 --steps 3 --trace t.json \\
      --metrics m.jsonl
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen-1.5b \\
      --reduced --device cpu --data-axis 2 --comm odc-overlap --steps 2 \\
      --ckpt-dir /tmp/ckpt --save-every 2
  ... --steps 3 --ckpt-dir /tmp/ckpt --resume   # continues at step 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen-1.5b \\
      --reduced --device cpu --comm cp --cp 2 --strategy lb_token --steps 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen-1.5b \\
      --reduced --device cpu --data-axis 4 --comm pipe-int8 --pipe-stages 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \\
      --reduced --device cpu --data-axis 2 --steps 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --reduced --device cpu --data-axis 2 --comm odc-overlap --steps 2
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch llama4-maverick-400b-a17b --reduced --device cpu \\
      --data-axis 2 --comm odc --steps 2

Where the flags mean something else than in ``repro.launch.train``: the
JAX driver lays its mesh over every host device and ignores
``--data-axis`` under cp, hier and pipe; here every rank lies on the one
card, so ``--data-axis`` sets the ranks: the world (nodes x devices, or
stages x data) under hier and pipe, and the cp groups (world = data x
cp) under cp.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.balance.cost import CostModel, make_straggler_profile
from repro_torch.checkpoint import latest_step, load_checkpoint, \
    save_checkpoint
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import backend as backends
from repro_torch.core.ranks import RankGroup
from repro_torch.core.train_step import Trainer
from repro_torch.data.loader import SyntheticSFTLoader
from repro_torch.data.packing import build_minibatch
from repro_torch.kernels import flash_attention, gather_matmul, \
    odc_gather, odc_scatter, quant, ssd_scan
from repro_torch.models import transformer as T
from repro_torch.obs import log as obs_log
from repro_torch.obs import metrics as obs_metrics
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedules import cosine_schedule, linear_warmup
from repro_torch.sim.trace import TraceRecorder, maybe_span

# kernel name -> (module, its launch counter)
KERNELS = {"flash_attention": (flash_attention, "launches"),
           "flash_attention_state": (flash_attention, "state_launches"),
           "odc_gather": (odc_gather, "launches"),
           "odc_scatter_accumulate": (odc_scatter, "launches"),
           "odc_gather_layers": (odc_gather, "layers_launches"),
           "odc_scatter_accumulate_layers": (odc_scatter, "layers_launches"),
           "quantize_int8": (quant, "quantize_launches"),
           "dequantize_int8": (quant, "dequantize_launches"),
           "odc_gather_q8": (quant, "gather_launches"),
           "odc_scatter_accumulate_q8": (quant, "scatter_launches"),
           "ssd_scan": (ssd_scan, "launches"),
           "gather_matmul": (gather_matmul, "launches")}
# the tuner's --config waits for the tuner (ROADMAP.md queue 1 item 8)
_NOT_PORTED_FLAGS = ("config",)


def reset_launches():
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)


def read_launches() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def refuse_unported(ap, args):
    """Exit through ``ap.error`` on what the port does not run yet: a
    tensor-parallel model axis, and the ``--comm`` / ``--schedule`` /
    family combinations that ``backend.resolve`` refuses (shared with
    ``launch.posttrain``); returns the backend that ``--comm`` names."""
    if args.model_axis != 1:
        ap.error("--model-axis > 1 is not yet ported to repro_torch "
                 "(ROADMAP.md queue 1 item 10)")
    backend = backends.get_backend(args.comm)
    schedule = backend.implied_schedule or args.schedule
    if schedule == "overlap" and (backend is backends.CP
                                  or backend.two_tier):
        ap.error(f"--comm {backend.name} under --schedule overlap is not "
                 f"yet ported to repro_torch (ROADMAP.md queue 1)")
    if (backend is backends.CP or backend.two_tier) \
            and T.is_moe(get_config(args.arch)):
        ap.error(f"--arch {args.arch} (the moe family) under --comm "
                 f"{backend.name} is not yet ported to repro_torch "
                 f"(ROADMAP.md queue 1 item 12); use --comm collective, "
                 f"odc or odc-overlap")
    if (backend is backends.CP or backend.two_tier) \
            and get_config(args.arch).family == "audio":
        ap.error(f"--arch {args.arch} (the audio family) under --comm "
                 f"{backend.name} is not yet ported to repro_torch "
                 f"(ROADMAP.md queue 1 item 14); use --comm collective, "
                 f"odc or odc-overlap")
    return backend


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen-1.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale variant of the same family")
    ap.add_argument("--dataset", default="longalign",
                    choices=("longalign", "swesmith", "aime"))
    ap.add_argument("--strategy", default="lb_mini",
                    choices=("local_sort", "lb_micro", "lb_mini",
                             "lb_mini_het", "lb_token"))
    ap.add_argument("--schedule", default="minibatch",
                    choices=backends.SCHEDULES,
                    help="where gathers/scatters are placed: 'layer' (per "
                         "layer per microbatch, FSDP baseline), "
                         "'minibatch' (once per minibatch, ODC) or "
                         "'overlap' (per microbatch, layer l+1 issued under "
                         "layer l; with a ring backend the chained ring "
                         "kernels) or '1f1b' ('minibatch' in the 1F1B issue "
                         "order; implied by --comm pipe/pipe-int8)")
    ap.add_argument("--comm", default="odc",
                    choices=backends.backend_names(),
                    help="how each gather/scatter moves bytes: 'collective' "
                         "(fused all-gather / reduce-scatter), 'odc' (p2p "
                         "ring, the hand-written CUDA kernels on the card), "
                         "'odc-overlap' (alias 'overlap': odc with the "
                         "overlap schedule implied) or 'cp' (alias "
                         "'cp-ring': odc over data x cp ranks with ring "
                         "attention inside each cp group, see --cp), "
                         "'hier' (intra-node concatenation + inter-node "
                         "ring over nodes x devices ranks, see --nodes), "
                         "'pipe' / 'pipe-int8' (hier's transport over "
                         "stages x data ranks under the 1F1B schedule, see "
                         "--pipe-stages; -int8 sends the inter tier as "
                         "chunked int8); the ssm and hybrid families "
                         "(mamba2, zamba2) take every choice but cp, the "
                         "moe family (grok-1, llama4-maverick) and the "
                         "audio family (seamless-m4t) collective, odc and "
                         "odc-overlap")
    ap.add_argument("--device-profile", default="none",
                    choices=("none", "homogeneous", "one_slow", "bimodal",
                             "uniform"),
                    help="simulated heterogeneity: balances plans for the "
                         "profile (strategy lb_mini_het) and routes the ODC "
                         "rings through the profile's device order")
    ap.add_argument("--slow-factor", type=float, default=2.0)
    ap.add_argument("--profile-jitter", type=float, default=0.0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--minibatch-per-device", type=int, default=4)
    ap.add_argument("--max-tokens", type=int, default=512,
                    help="microbatch token budget (memory model)")
    ap.add_argument("--max-len", type=int, default=384,
                    help="rescale the length distribution to this max")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--cosine", action="store_true",
                    help="cosine decay to 10%% over --steps (with warmup)")
    ap.add_argument("--data-axis", type=int, default=0,
                    help="ranks, all on the current card: the world (with "
                         "--comm hier: nodes x devices; with pipe: stages "
                         "x data), or with --comm cp the cp groups (world "
                         "= data x cp); the JAX driver instead takes every "
                         "host device under cp, hier and pipe; 0 = one per "
                         "visible device, refused on more than one card "
                         "(ranks on separate cards are not yet ported)")
    ap.add_argument("--cp", type=int, default=None,
                    help="with --comm cp/cp-ring: the context-parallel "
                         "degree (default 2); each ring group of cp "
                         "adjacent ranks sequence-shards its rows, so "
                         "--max-tokens is each rank's budget and a group "
                         "row holds cp times as many")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="1 only (tensor parallelism is not yet ported)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", "--ckpt-every", type=int, default=0,
                    dest="save_every",
                    help="checkpoint (params + optimizer) to --ckpt-dir "
                         "every N steps (alias: --ckpt-every)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --ckpt-dir "
                         "(bit-identical to an uninterrupted run: the "
                         "loader replays the skipped steps' data stream)")
    ap.add_argument("--trace", default="",
                    help="write a Chrome-trace JSON of the run's wall-clock "
                         "step timing (host and trainer lanes, the "
                         "simulator's timeline schema; open in "
                         "chrome://tracing or ui.perfetto.dev)")
    ap.add_argument("--metrics", default="",
                    help="write per-step metrics snapshots (train.* gauges "
                         "and counters, the comm.* counters and message-size "
                         "histograms per backend, op and tier) as JSONL, "
                         "the JAX driver's counter names")
    ap.add_argument("--config", default="",
                    help="not yet ported: the tuner's result file waits for "
                         "the tuner (ROADMAP.md queue 1 item 8)")
    ap.add_argument("--nodes", type=int, default=2,
                    help="with --comm hier: the nodes, each of "
                         "world / nodes ranks (devices)")
    ap.add_argument("--pipe-stages", type=int, default=2,
                    help="with --comm pipe/pipe-int8: the pipeline stages, "
                         "each of world / stages ranks; also the depth of "
                         "the 1F1B order")
    ap.add_argument("--pipe-interleave", action="store_true",
                    help="with the 1f1b schedule: the interleaved order "
                         "(halved warmup)")
    obs_log.add_log_args(ap)
    args = ap.parse_args(argv)
    for flag in _NOT_PORTED_FLAGS:
        if getattr(args, flag):
            ap.error(f"--{flag.replace('_', '-')} is not yet ported to "
                     f"repro_torch (ROADMAP.md queue 1 item 8: the tuner); "
                     f"use repro.launch.train")
    backend = refuse_unported(ap, args)
    args.inter = 2
    if backend.two_tier:
        args.inter = (args.nodes if backend.name == "hier"
                      else args.pipe_stages)
        what = "--nodes" if backend.name == "hier" else "--pipe-stages"
        if args.inter < 1 or (args.data_axis and args.data_axis % args.inter):
            ap.error(f"--comm {backend.name}: {args.data_axis or 'the'} "
                     f"ranks do not split into {what} {args.inter} groups "
                     f"of equal size")
    if backend is backends.CP:
        args.cp = 2 if args.cp is None else args.cp
        if args.cp < 1:
            ap.error("--cp must be at least 1")
    elif args.cp is not None:
        ap.error("--cp applies to --comm cp (or cp-ring) only")
    else:
        args.cp = 1
    return args


def stub_extras(cfg, step: int):
    """The stub frontends' embeddings of one step's batch
    (``repro.launch.train``'s ``extras_for``), drawn from
    ``numpy.random.RandomState(step)`` so that a resumed run draws what an
    uninterrupted one would have: for the audio family 16 frames a
    microbatch row (``encoder_embeds``), for a vision frontend its patch
    embeddings (``vision_embeds``); else None.  ``build_minibatch`` calls
    each with (M, W)."""
    if cfg.family == "audio":
        rng = np.random.RandomState(step)
        return {"encoder_embeds": lambda M, W: rng.randn(
            M, W, 16, cfg.d_model).astype(np.float32)}
    if cfg.frontend == "vision" and cfg.frontend_tokens:
        rng = np.random.RandomState(step)
        return {"vision_embeds": lambda M, W: rng.randn(
            M, W, cfg.frontend_tokens, cfg.d_model).astype(np.float32)}
    return None


def _sync(ranks):
    if ranks.devices[0].type == "cuda":
        torch.cuda.synchronize(ranks.devices[0])


def run(args, *, return_params: bool = False, cfg=None,
        moe_ep: str = "none") -> dict:
    """Train as the flags say; returns the run's summary (with the final
    parameters, unsharded on the CPU, under "params" if asked).  ``cfg``:
    a model configuration to train in place of ``--arch``'s (a full-width
    model cut in depth, for one).  ``moe_ep``: the Trainer's (the JAX
    engine's ``GSPMDConfig.moe_ep``, which its driver sets no flag for
    either)."""
    out = obs_log.from_args("train", args)
    if args.resume and not args.ckpt_dir:
        raise SystemExit("--resume needs --ckpt-dir")
    ranks = RankGroup.make(args.data_axis, args.device)
    if args.cp > 1:  # data groups of cp ranks each
        ranks = RankGroup.make(ranks.n * args.cp, args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg is None:
        cfg = get_reduced(args.arch) if args.reduced \
            else get_config(args.arch)
    world = ranks.n
    profile = None
    if args.device_profile != "none":
        profile = make_straggler_profile(
            args.device_profile, world, slow_factor=args.slow_factor,
            seed=args.seed, jitter=args.profile_jitter)
        out.info(f"device profile {args.device_profile}: speeds="
                 f"{[round(s, 3) for s in profile.speeds]}")

    lr_schedule = None
    if args.cosine:
        lr_schedule = lambda s: cosine_schedule(s, args.steps,
                                                args.warmup_steps)
    elif args.warmup_steps:
        lr_schedule = lambda s: linear_warmup(s, args.warmup_steps)
    trainer = Trainer(cfg, ranks, comm=args.comm, schedule=args.schedule,
                      opt_cfg=AdamWConfig(lr=args.lr),
                      lr_schedule=lr_schedule, device_profile=profile,
                      cp=args.cp, inter=args.inter,
                      pipe_interleave=args.pipe_interleave, moe_ep=moe_ep)
    comm, schedule = trainer.backend.name, trainer.schedule
    tiers = trainer.tiers
    out.info(f"{cfg.name} ({cfg.family}) on {world} ranks "
             f"{[str(d) for d in ranks.devices]}"
             + (f" (data {world // args.cp} x cp {args.cp})"
                if comm == "cp" else "")
             + (f" ({'nodes' if comm == 'hier' else 'stages'} "
                f"{tiers.inter} x {tiers.intra})" if tiers else "")
             + f" strategy={args.strategy} schedule={schedule} comm={comm}"
             + (" moe_ep=data (weight-stationary experts)" if trainer.ep
                else ""))

    start_step = 0
    last = latest_step(args.ckpt_dir) if args.resume else None
    if last is not None:
        shards, opt = trainer.restore(load_checkpoint(
            args.ckpt_dir, last, trainer.state_like()))
        start_step = last
        out.info(f"resumed from {args.ckpt_dir} at step {last}")
    else:
        if args.resume:
            out.info(f"--resume: no checkpoint in {args.ckpt_dir!r}, "
                     f"starting fresh")
        gen = torch.Generator(device=ranks.devices[0]).manual_seed(args.seed)
        params = T.init_params(cfg, gen)
        shards, opt = trainer.init_state(params)
        del params

    cm = CostModel(attention_free=cfg.is_attention_free,
                   window=cfg.sliding_window)
    loader = SyntheticSFTLoader(
        args.dataset, vocab_size=cfg.vocab_size, world_size=world,
        minibatch_per_device=args.minibatch_per_device,
        max_tokens=args.max_tokens, strategy=args.strategy,
        max_len=args.max_len, cost_model=cm, seed=args.seed,
        device_profile=profile, cp=args.cp)

    rec = None
    if args.trace:
        rec = TraceRecorder(meta={
            "driver": "launch.train", "arch": cfg.name,
            "strategy": args.strategy, "schedule": args.schedule,
            "comm": comm, "world": world})
    reg = None
    if args.metrics:
        reg = obs_metrics.MetricsRegistry(meta={
            "driver": "launch.train", "arch": cfg.name,
            "strategy": args.strategy, "schedule": args.schedule,
            "comm": comm, "world": world, "source": "real"})
        reg.attach_jsonl(args.metrics)
        obs_metrics.set_active(reg)

    reset_launches()
    if ranks.devices[0].type == "cuda":
        torch.cuda.reset_peak_memory_stats(ranks.devices[0])
    t_start = time.time()
    samples_done = tokens_done = 0
    losses, step_s, steps, saved = [], [], [], []
    try:
        for i, step_data in enumerate(
                loader.steps(args.steps, skip=start_step), start=start_step):
            plan = step_data["plan"]
            with maybe_span(rec, "host", "compute", f"build minibatch {i}"):
                batch = build_minibatch(plan, step_data["sample_tokens"],
                                        args.max_tokens,
                                        extras=stub_extras(cfg, i))
            counts = [len(a) for a in plan.assignments]
            split = len(getattr(plan, "cp_split", ()))
            t0 = time.time()
            with maybe_span(rec, "trainer", "compute", f"train step {i}"):
                shards, opt, metrics = trainer.step(shards, opt, batch,
                                                    counts)
                loss = float(metrics["loss"])  # waits for the device
                tokens = float(metrics["tokens"])
                _sync(ranks)
            dt = time.time() - t0
            samples_done += len(step_data["lengths"])
            tokens_done += tokens
            losses.append(loss)
            step_s.append(dt)
            steps.append({"microbatches": int(batch["tokens"].shape[0]),
                          "counts": counts, "tokens": tokens,
                          "grad_norm": float(metrics["grad_norm"]),
                          "cp_split": split})
            if reg is not None:
                reg.gauge("train.loss").set(loss)
                reg.gauge("train.step_s").set(dt)
                reg.counter("train.tokens").inc(tokens)
                reg.counter("train.samples").inc(
                    float(len(step_data["lengths"])))
                reg.step(i)
                if rec is not None:
                    rec.count("comm wire bytes",
                              reg.total("comm.bytes_wire"))
            out.step(i, f"step {i:4d} loss={loss:.4f} tokens={tokens:.0f} "
                        f"M={plan.max_microbatches} dt={dt:.2f}s "
                        f"tok/s={tokens / max(dt, 1e-9):.0f}"
                        + (f" cp-split={split}" if args.cp > 1 else ""))
            if args.ckpt_dir and args.save_every \
                    and (i + 1) % args.save_every == 0:
                with maybe_span(rec, "host", "push",
                                f"checkpoint step {i + 1}"):
                    save_checkpoint(args.ckpt_dir, i + 1,
                                    trainer.state_tree(shards, opt))
                saved.append(i + 1)
    finally:
        if reg is not None:
            obs_metrics.set_active(None)
            reg.close()
    dt = time.time() - t_start
    launches = read_launches()
    peak = (torch.cuda.max_memory_allocated(ranks.devices[0])
            if ranks.devices[0].type == "cuda" else 0)
    if rec is not None:
        out.always(f"wrote trace {rec.write(args.trace)}")
    if reg is not None:
        out.always(f"wrote metrics {args.metrics}")
    if not losses:
        out.always(f"done: no training steps run (--steps {args.steps}); "
                   f"setup OK")
    else:
        out.always(f"done: {samples_done} samples in {dt:.1f}s "
                   f"({samples_done / dt:.2f} samples/s, "
                   f"{tokens_done / dt:.0f} tok/s) final loss={losses[-1]:.4f}")
        out.always(f"kernel launches: {launches}"
                   + (f"; peak device memory {peak / 2**30:.2f} GiB"
                      if peak else ""))
    summary = {"losses": losses, "step_s": step_s, "steps": steps,
               "launches": launches, "world": world,
               "num_layers": cfg.num_layers, "dims": trainer.dims,
               "comm": comm, "schedule": schedule, "cp": args.cp,
               "tiers": (tiers.inter, tiers.intra) if tiers else None,
               "start_step": start_step, "saved": saved,
               "tokens": tokens_done, "seconds": dt,
               "tok_s": tokens_done / dt if dt > 0 else 0.0,
               "peak_bytes": peak, "ep": trainer.ep}
    if return_params:
        summary["params"] = trainer.unshard(shards)
    return summary


def main(argv=None):
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
