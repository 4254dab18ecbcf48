"""SFT training driver, the PyTorch counterpart of ``repro.launch.train``.

Synthetic length-realistic data -> a load-balancing strategy (LocalSort /
LB-Micro / LB-Mini) -> sequence packing -> the FSDP train step over the
ranks of a ``RankGroup`` (``--comm odc --schedule minibatch``, the
paper's ODC, or ``--comm collective --schedule layer``, the FSDP
baseline) -> sharded AdamW.  One process holds every rank; on one card
every rank lies on it, so ``--data-axis 2`` trains with two ranks on one
H100 and each ODC ring is one launch of a hand-written CUDA kernel.

Weights are random, drawn from ``--seed`` by a ``torch.Generator`` on the
target device, in float32; float32 products run in full f32 (TF32 off).
Runs on the card unless ``--device cpu`` is given.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen-1.5b \\
      --data-axis 2 --steps 3 --max-tokens 4096 --max-len 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen-1.5b \\
      --reduced --device cpu --data-axis 2 --steps 3
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.balance.cost import CostModel, make_straggler_profile
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import backend as backends
from repro_torch.core.ranks import RankGroup
from repro_torch.core.train_step import Trainer
from repro_torch.data.loader import SyntheticSFTLoader
from repro_torch.data.packing import build_minibatch
from repro_torch.kernels import flash_attention, odc_gather, odc_scatter
from repro_torch.models import transformer as T
from repro_torch.obs import log as obs_log
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedules import cosine_schedule, linear_warmup

KERNELS = {"flash_attention": flash_attention, "odc_gather": odc_gather,
           "odc_scatter_accumulate": odc_scatter}
_NOT_PORTED_FLAGS = ("ckpt_dir", "resume", "save_every", "trace", "metrics",
                     "config", "pipe_interleave")


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
                         "layer per microbatch, FSDP baseline) or "
                         "'minibatch' (once per minibatch, ODC); 'overlap' "
                         "and '1f1b' are not yet ported")
    ap.add_argument("--comm", default="odc",
                    choices=backends.backend_names() + backends.NOT_PORTED,
                    help="how each gather/scatter moves bytes: 'collective' "
                         "(fused all-gather / reduce-scatter) or 'odc' (p2p "
                         "ring, the hand-written CUDA kernels on the card); "
                         "the other JAX backends are not yet ported")
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
                    help="ranks, all on the current card; 0 = one per "
                         "visible device, refused on more than one card "
                         "(ranks on separate cards are not yet ported)")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="1 only (tensor parallelism is not yet ported)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    for flag in ("--ckpt-dir", "--trace", "--metrics", "--config"):
        ap.add_argument(flag, default="", help="not yet ported")
    ap.add_argument("--save-every", type=int, default=0,
                    help="not yet ported")
    ap.add_argument("--resume", action="store_true", help="not yet ported")
    ap.add_argument("--pipe-interleave", action="store_true",
                    help="not yet ported")
    for flag in ("--nodes", "--pipe-stages", "--cp"):
        ap.add_argument(flag, type=int, default=0, help="not yet ported")
    obs_log.add_log_args(ap)
    args = ap.parse_args(argv)
    for flag in _NOT_PORTED_FLAGS + ("nodes", "pipe_stages", "cp"):
        if getattr(args, flag):
            ap.error(f"--{flag.replace('_', '-')} is not yet ported to "
                     f"repro_torch (ROADMAP §0); use repro.launch.train")
    if args.model_axis != 1:
        ap.error("--model-axis > 1 is not yet ported to repro_torch "
                 "(ROADMAP §0)")
    if args.comm in backends.NOT_PORTED:
        ap.error(f"--comm {args.comm} is not yet ported to repro_torch "
                 f"(ROADMAP §0)")
    if args.schedule not in ("layer", "minibatch"):
        ap.error(f"--schedule {args.schedule} is not yet ported to "
                 f"repro_torch (ROADMAP §0)")
    return args


def _sync(ranks):
    if ranks.devices[0].type == "cuda":
        torch.cuda.synchronize(ranks.devices[0])


def run(args) -> dict:
    """Train as the flags say; returns the run's summary."""
    out = obs_log.from_args("train", args)
    ranks = RankGroup.make(args.data_axis, args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    world = ranks.n
    out.info(f"{cfg.name} ({cfg.family}) on {world} ranks "
             f"{[str(d) for d in ranks.devices]} strategy={args.strategy} "
             f"schedule={args.schedule} comm={args.comm}")

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
                      lr_schedule=lr_schedule, device_profile=profile)

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
        device_profile=profile)

    for mod in KERNELS.values():
        mod.launches = 0
    if ranks.devices[0].type == "cuda":
        torch.cuda.reset_peak_memory_stats(ranks.devices[0])
    t_start = time.time()
    samples_done = tokens_done = 0
    losses, step_s, steps = [], [], []
    for i, step_data in enumerate(loader.steps(args.steps)):
        plan = step_data["plan"]
        batch = build_minibatch(plan, step_data["sample_tokens"],
                                args.max_tokens)
        counts = [len(a) for a in plan.assignments]
        t0 = time.time()
        shards, opt, metrics = trainer.step(shards, opt, batch, counts)
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
                      "grad_norm": float(metrics["grad_norm"])})
        out.step(i, f"step {i:4d} loss={loss:.4f} tokens={tokens:.0f} "
                    f"M={plan.max_microbatches} dt={dt:.2f}s "
                    f"tok/s={tokens / max(dt, 1e-9):.0f}")
    dt = time.time() - t_start
    launches = {name: mod.launches for name, mod in KERNELS.items()}
    peak = (torch.cuda.max_memory_allocated(ranks.devices[0])
            if ranks.devices[0].type == "cuda" else 0)
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
    return {"losses": losses, "step_s": step_s, "steps": steps,
            "launches": launches, "world": world,
            "num_layers": cfg.num_layers, "dims": trainer.dims,
            "tokens": tokens_done, "seconds": dt,
            "tok_s": tokens_done / dt if dt > 0 else 0.0,
            "peak_bytes": peak}


def main(argv=None):
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
