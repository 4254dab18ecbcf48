"""The rollout->train orchestration loop with bounded staleness, the
PyTorch counterpart of ``repro.posttrain.pipeline``.

Dataflow (one arrow per subsystem seam):

    generator (GenerationEngine / ContinuousGenerationEngine / the
               synthetic sampler)
        | variable-length rollouts, tagged with their weight version
        v
    RolloutBuffer  -- FIFO dispatch queue, staleness bound enforced
        | a minibatch's worth, as soon as enough rollouts landed
        v
    balancer (LB-Mini / LB-Mini-Het via balance.strategies.make_plan)
        v
    trainer (``core.train_step.Trainer.step`` over the ranks' shards)
        | after each optimizer step
        v
    weight push (``posttrain.weight_push.WeightPusher``) --> generator

Staleness semantics (SSP on top of ODC, paper §6.2): wave ``w``, consumed
by train step ``w``, may be generated under weights at most ``staleness``
versions old (``w - version <= K``).  The loop is one process, so the
generator/trainer overlap is scheduled, not run in parallel; what the
loop realizes exactly is the ordering contract:

  * K = 0: push, generate the full wave, train -- the synchronous
    alternating loop, bit for bit;
  * K >= 1: the generator runs up to K waves ahead of the trainer on the
    weights it last pulled, and the buffer proves every dispatched
    rollout honoured the bound.

Telemetry: with ``trace`` (a ``sim.trace.TraceRecorder``) every wave, push
and train step is a wall-clock span on the ``generator``, ``push`` and
``trainer`` lanes, each ending after the device has finished its work (a
wave's tokens reach the host, a push synchronises, a step's loss is read);
with an ``obs.metrics`` registry active each step sets the
``posttrain.loss``, ``posttrain.staleness``, ``posttrain.buffer_depth``
and ``posttrain.step_s`` gauges, adds to the ``posttrain.rollouts`` and
``posttrain.tokens`` counters and snapshots the registry.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

from repro_torch.obs import metrics as obs_metrics
from repro_torch.posttrain.buffer import RolloutBuffer
from repro_torch.sim.trace import maybe_span


@dataclasses.dataclass
class PostTrainPipeline:
    """Orchestrates task <-> buffer <-> trainer <-> weight push.

    task         a GRPOTask / SFTTask adapter
    step_fn      (shards, opt_states, batch, counts) -> (shards,
                 opt_states, metrics): ``Trainer.step``; ``counts`` are
                 the plan's microbatches per batch row
    world        FSDP world size (the balancer's width)
    staleness    SSP bound K (0 = synchronous)
    pusher       optional WeightPusher; None = the generator gets
                 ``unshard(shards)`` (or the shards as they are, which the
                 synthetic sources and the SFT loader never read)
    unshard      without a pusher: the trainer's shards -> the full tree
                 the generator reads
    trace        optional ``sim.trace.TraceRecorder``
    live_engine  optional ``ContinuousGenerationEngine``: pushes go
                 through ``pusher.push_live`` INTO the running engine
                 (versioned publish between decode steps, barrier
                 semantics from the backend's ``push_blocks_trainer``);
                 the engine records its own push events on its scheduled
                 clock, so the pipeline's wall-clock push span is skipped
    log          optional ``obs.log.RunLog`` for the per-step rows
    """

    task: Any
    step_fn: Callable
    world: int
    staleness: int = 0
    pusher: Optional[Any] = None
    unshard: Optional[Callable] = None
    trace: Optional[Any] = None
    live_engine: Optional[Any] = None
    log: Optional[Any] = None

    def __post_init__(self):
        self.buffer = RolloutBuffer(self.staleness)
        self.next_wave = 0
        self.trained = 0
        self.metrics: List[dict] = []

    # -- generator side -----------------------------------------------------
    def _gen_params(self, params):
        if self.pusher is None:
            view = params if self.unshard is None else self.unshard(params)
            return view, self.trained
        if self.pusher.version < self.trained:
            if self.live_engine is not None:
                # the push lands inside the running engine, which traces
                # it itself
                self.pusher.push_live(self.live_engine, params,
                                      self.trained)
            else:
                with maybe_span(self.trace, "push", "push",
                                f"weights v{self.trained}"):
                    self.pusher.push(params, self.trained)
        return self.pusher.params, self.pusher.version

    def _fill(self, params, total_iters: int):
        """Generate every wave the staleness bound currently allows: wave
        w needs weights of version >= w - K, and the generator holds
        version ``trained``, so waves up to trained + K are legal."""
        while (self.next_wave < total_iters
               and self.next_wave <= self.trained + self.staleness):
            gp, gv = self._gen_params(params)
            with maybe_span(self.trace, "generator", "decode",
                            f"wave {self.next_wave} (weights v{gv})"):
                wave = self.task.generate_wave(self.next_wave, gp, gv)
            self.buffer.put(wave, gv)
            self.next_wave += 1

    # -- the loop -----------------------------------------------------------
    def run(self, iters: int, params, opt_state, *, verbose: bool = True):
        """Run ``iters`` MORE train steps; returns (params, opt_state,
        metrics: one dict per NEW step with loss, tokens, staleness and
        the microbatch shape).  Re-entrant: a second call continues the
        same schedule (wave indices, versions and the FIFO stream carry
        on), so ``run(2); run(2)`` consumes the sample stream of
        ``run(4)``."""
        first_new = len(self.metrics)
        total = self.trained + iters
        for t in range(self.trained, total):
            self._fill(params, total)
            rollouts = self.buffer.pop(self.task.wave_size, train_step=t)
            plan, batch = self.task.build_batch(rollouts, self.world)
            counts = [len(d) for d in plan.assignments]
            t0 = time.time()
            with maybe_span(self.trace, "trainer", "compute",
                            f"train step {t}"):
                with obs_metrics.program("posttrain_step"):
                    params, opt_state, m = self.step_fn(
                        params, opt_state, batch, counts)
                loss = float(m["loss"])  # waits for the device
            self.trained = t + 1
            row = {
                "step": t,
                "loss": loss,
                "tokens": float(m["tokens"]),
                "rollouts": len(rollouts),
                "staleness": max((t - r.version for r in rollouts),
                                 default=0),  # empty wave (wave_size 0)
                "microbatches": counts,
                "dt": time.time() - t0,
                "pushes": self.pusher.pushes if self.pusher else 0,
            }
            self.metrics.append(row)
            reg = obs_metrics.active()
            if reg is not None:
                reg.gauge("posttrain.loss").set(loss)
                reg.gauge("posttrain.staleness").set(row["staleness"])
                reg.gauge("posttrain.buffer_depth").set(len(self.buffer))
                reg.gauge("posttrain.step_s").set(row["dt"])
                reg.counter("posttrain.rollouts").inc(row["rollouts"])
                reg.counter("posttrain.tokens").inc(row["tokens"])
                reg.step(t)
            msg = (f"step {t:4d} loss={row['loss']:+.5f} "
                   f"rollouts={row['rollouts']} "
                   f"staleness={row['staleness']} "
                   f"M={plan.max_microbatches} dt={row['dt']:.2f}s")
            if self.log is not None:
                self.log.step(t, msg)
            elif verbose:
                print(f"[posttrain] {msg}")
        return params, opt_state, self.metrics[first_new:]
