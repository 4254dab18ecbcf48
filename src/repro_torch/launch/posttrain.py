"""Post-training driver: rollout -> train with the weight push, the
PyTorch counterpart of ``repro.launch.posttrain``.

Routes both post-training workloads (GRPO RL and SFT) through the
``repro_torch.posttrain`` subsystem: generator -> RolloutBuffer (bounded
staleness) -> LB-Mini balancer -> the FSDP train step over the ranks of
a ``RankGroup`` -> the weight push from the trainer's shards.

``--staleness 0`` replays the synchronous alternating loop bit for bit;
``--staleness K`` lets the generator run K waves ahead on the weights it
last pulled.  ``--rollout engine`` generates the rollouts with a
prefill/decode ``GenerationEngine`` under the pushed weights
(``synthetic`` uses the paper's seeded sampler and skips generation, its
measurement convention); ``--rollout continuous`` streams the same
rollouts through the in-flight batching engine, each weight push landing
between decode steps (``push_live``).  The push gathers every sharded
leaf with the ``--comm`` backend: under ``odc`` one launch of the
hand-written gather kernel a leaf on the card.

One process holds every rank: ``--data-axis`` ranks (default 2) share
the current card, as in ``launch.train``; the generator's parameters and
KV cache lie on it too.  Weights are random, drawn from ``--seed`` by a
``torch.Generator`` on the target device, in float32 (TF32 off).  Runs
on the card unless ``--device cpu`` is given.  ``--trace`` writes the
wall-clock generator / push / trainer spans (with ``--rollout
continuous`` also the engine's per-slot lanes on its scheduled clock) as
a Chrome trace; ``--metrics`` the per-step ``posttrain.*``, ``engine.*``
and ``comm.*`` rows as JSONL (``comm.*{op=push}`` once per push).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.posttrain --task grpo \\
      --rollout engine --comm odc --staleness 1
  PYTHONPATH=src python -m repro_torch.launch.posttrain --task grpo \\
      --reduced --device cpu --iters 3 --staleness 1 --comm odc \\
      --rollout engine --trace t.json --metrics m.jsonl
  PYTHONPATH=src python -m repro_torch.launch.posttrain --task sft \\
      --reduced --device cpu --iters 3 --dataset longalign

Where the flags mean something else than in ``repro.launch.posttrain``:
the JAX driver lays its mesh over every host device; here every rank
lies on the one card and ``--data-axis`` sets the world (nodes x devices
under hier, stages x data under pipe).  Refused as not yet ported:
``--config`` (the tuner, ROADMAP.md queue 1 item 8), ``--model-axis`` >
1 and the ``--comm`` / ``--schedule`` / family combinations the train
driver refuses; ``--comm cp``, which the JAX post-training driver does
not run either (it lays no cp axis).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.balance.cost import CostModel
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import backend as backends
from repro_torch.core.ranks import RankGroup
from repro_torch.core.train_step import Trainer
from repro_torch.launch.train import refuse_unported
from repro_torch.models import transformer as T
from repro_torch.obs import log as obs_log
from repro_torch.obs import metrics as obs_metrics
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.posttrain.engine import (ContinuousGenerationEngine,
                                          GenerationEngine)
from repro_torch.posttrain.pipeline import PostTrainPipeline
from repro_torch.posttrain.tasks import GRPOTask, SFTTask
from repro_torch.posttrain.weight_push import WeightPusher
from repro_torch.sim.trace import TraceRecorder


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.posttrain")
    ap.add_argument("--task", default="grpo", choices=("grpo", "sft"))
    ap.add_argument("--arch", default="qwen-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--staleness", type=int, default=0,
                    help="SSP bound K: the generator may run K waves ahead "
                         "of the trainer on last-pushed weights (0 = the "
                         "synchronous alternating loop, bit-identical)")
    ap.add_argument("--strategy", default="lb_mini",
                    choices=("local_sort", "lb_micro", "lb_mini",
                             "lb_mini_het"))
    ap.add_argument("--schedule", default="minibatch",
                    choices=backends.SCHEDULES)
    ap.add_argument("--comm", default="odc",
                    choices=backends.backend_names(),
                    help="comm backend of BOTH the train step and the "
                         "trainer->generator weight push (the p2p backends "
                         "push without a barrier); 'hier' lays the ranks "
                         "out as nodes x devices, see --nodes")
    ap.add_argument("--nodes", type=int, default=2,
                    help="with --comm hier: the nodes, each of world / "
                         "nodes ranks")
    ap.add_argument("--pipe-stages", type=int, default=2,
                    help="with --comm pipe/pipe-int8: the pipeline stages, "
                         "each of world / stages ranks")
    ap.add_argument("--data-axis", type=int, default=2,
                    help="ranks, all on the current card: the world (with "
                         "--comm hier: nodes x devices; with pipe: stages "
                         "x data); the JAX driver takes every host device")
    ap.add_argument("--rollout", default="synthetic",
                    choices=("synthetic", "engine", "continuous"),
                    help="grpo only: 'engine' decodes real rollouts with "
                         "a GenerationEngine under the pushed weights; "
                         "'continuous' streams them through a "
                         "ContinuousGenerationEngine with live versioned "
                         "weight pushes between decode steps")
    ap.add_argument("--slots", type=int, default=4,
                    help="--rollout continuous: decode lanes of the "
                         "in-flight batching engine")
    ap.add_argument("--no-push", action="store_true",
                    help="skip the weight push (synthetic rollouts never "
                         "read generator params)")
    # grpo knobs
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--group", type=int, default=4)
    ap.add_argument("--rollout-max-len", type=int, default=192)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--length-variance", type=float, default=1.0)
    # sft knobs
    ap.add_argument("--dataset", default="longalign",
                    choices=("longalign", "swesmith", "aime"))
    ap.add_argument("--minibatch-per-device", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=384)
    # shared
    ap.add_argument("--max-tokens", type=int, default=256,
                    help="microbatch token budget")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--model-axis", type=int, default=1,
                    help="1 only (tensor parallelism is not yet ported)")
    ap.add_argument("--trace", default="",
                    help="write a Chrome-trace JSON of the pipeline's "
                         "wall-clock events (wave generation, weight "
                         "pushes, train steps) in the simulator's timeline "
                         "schema")
    ap.add_argument("--metrics", default="",
                    help="write per-step metrics snapshots (comm counters, "
                         "staleness/buffer gauges) as JSONL")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--config", default="",
                    help="not yet ported: the tuner's result file waits for "
                         "the tuner (ROADMAP.md queue 1 item 8)")
    obs_log.add_log_args(ap)
    args = ap.parse_args(argv)
    if args.config:
        ap.error("--config is not yet ported to repro_torch (ROADMAP.md "
                 "queue 1 item 8: the tuner); use repro.launch.posttrain")
    backend = refuse_unported(ap, args)
    if backend is backends.CP:
        ap.error("--comm cp is not yet ported to the post-training driver "
                 "(the JAX post-training driver lays no cp axis either); "
                 "use launch.train --comm cp")
    args.inter = 2
    if backend.two_tier:
        args.inter = (args.nodes if backend.name == "hier"
                      else args.pipe_stages)
        what = "--nodes" if backend.name == "hier" else "--pipe-stages"
        if args.inter < 1 or args.data_axis % args.inter:
            ap.error(f"--comm {backend.name}: {args.data_axis} ranks do "
                     f"not split into {what} {args.inter} groups of equal "
                     f"size")
    return args


def build(args, cfg=None):
    """The run's pieces: ``(cfg, trainer, shards, opt states, pipeline,
    engine, pusher, trace recorder)``.  ``cfg``: a model configuration to
    run in place of ``--arch``'s."""
    ranks = RankGroup.make(args.data_axis, args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg is None:
        cfg = get_reduced(args.arch) if args.reduced \
            else get_config(args.arch)
    device = ranks.devices[0]
    trainer = Trainer(cfg, ranks, comm=args.comm, schedule=args.schedule,
                      opt_cfg=AdamWConfig(lr=args.lr), inter=args.inter)
    world = ranks.n
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init_params(cfg, gen)
    shards, opt = trainer.init_state(params)
    del params

    # the same arch-aware cost model as launch.train, so the balancer's
    # plans match the synchronous driver's
    cm = CostModel(attention_free=cfg.is_attention_free,
                   window=cfg.sliding_window)
    comm = trainer.backend.name
    rec = None
    if args.trace:
        rec = TraceRecorder(meta={
            "driver": "launch.posttrain", "arch": cfg.name,
            "task": args.task, "comm": comm,
            "staleness": args.staleness, "world": world})
    engine = None
    if args.task == "grpo":
        if args.rollout == "engine":
            engine = GenerationEngine(cfg, device=device)
        elif args.rollout == "continuous":
            engine = ContinuousGenerationEngine(
                cfg, slots=args.slots, max_len=args.rollout_max_len,
                device=device, trace=rec)
        task = GRPOTask(
            vocab_size=cfg.vocab_size, prompts=args.prompts,
            group=args.group, max_len=args.rollout_max_len,
            max_tokens=args.max_tokens, strategy=args.strategy,
            seed=args.seed, length_variance=args.length_variance,
            rollout_source=args.rollout, engine=engine,
            prompt_len=args.prompt_len, cost_model=cm)
    else:
        task = SFTTask(
            vocab_size=cfg.vocab_size, world=world, dataset=args.dataset,
            minibatch_per_device=args.minibatch_per_device,
            max_tokens=args.max_tokens, max_len=args.max_len,
            strategy=args.strategy, seed=args.seed, cost_model=cm)

    # only engine-backed rollouts read the generator's params; synthetic
    # GRPO and the SFT loader do not, so a push every step would be
    # wasted gather traffic
    reads = args.task == "grpo" and args.rollout in ("engine", "continuous")
    pusher = WeightPusher(trainer) if reads and not args.no_push else None
    live = engine if pusher is not None and args.rollout == "continuous" \
        else None
    pipe = PostTrainPipeline(
        task=task, step_fn=trainer.step, world=world,
        staleness=args.staleness, pusher=pusher,
        unshard=(lambda s: trainer.unshard(s, device)) if reads else None,
        trace=rec, live_engine=live,
        log=obs_log.from_args("posttrain", args))
    return cfg, trainer, shards, opt, pipe, engine, pusher, rec


def run(args, cfg=None) -> dict:
    """Post-train as the flags say; returns the run's summary."""
    out = obs_log.from_args("posttrain", args)
    cfg, trainer, shards, opt, pipe, engine, pusher, rec = build(args, cfg)
    comm = trainer.backend.name
    out.info(f"{cfg.name} task={args.task} ranks={trainer.ranks.n} "
             f"({trainer.ranks.devices[0]}) staleness={args.staleness} "
             f"comm={comm} strategy={args.strategy} rollout="
             f"{args.rollout if args.task == 'grpo' else 'loader'}")
    reg = None
    if args.metrics:
        reg = obs_metrics.MetricsRegistry(meta={
            "driver": "launch.posttrain", "arch": cfg.name,
            "task": args.task, "comm": comm,
            "staleness": args.staleness, "world": trainer.ranks.n,
            "source": "real"})
        reg.attach_jsonl(args.metrics)
        obs_metrics.set_active(reg)
    t0 = time.time()
    try:
        shards, opt, metrics = pipe.run(args.iters, shards, opt)
    finally:
        if reg is not None:
            obs_metrics.set_active(None)
            reg.close()
    dt = time.time() - t0
    if rec is not None:
        out.always(f"wrote trace {rec.write(args.trace)}")
    if reg is not None:
        out.always(f"wrote metrics {args.metrics}")
    summary = {"metrics": metrics, "seconds": dt,
               "pushes": pusher.pushes if pusher else 0,
               "max_staleness": pipe.buffer.max_staleness_seen,
               "push_stall_s": getattr(engine, "push_stall_s", 0.0),
               "comm": comm, "world": trainer.ranks.n}
    if not metrics:
        out.always(f"done: no steps run (--iters {args.iters}); setup OK")
        return summary
    n = sum(m["rollouts"] for m in metrics)
    out.always(f"done: {n} rollouts / {len(metrics)} steps in "
               f"{dt:.1f}s  final loss={metrics[-1]['loss']:+.5f}  "
               f"max staleness seen={pipe.buffer.max_staleness_seen}  "
               f"pushes={summary['pushes']}")
    return summary


def main(argv=None):
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
