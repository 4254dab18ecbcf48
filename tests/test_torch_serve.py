"""The port's serving path on the CPU: engines, allocator and CLI.

* wave ``generate`` against the JAX ``GenerationEngine.generate`` (set up
  as in ``tests/test_continuous_batching.py``): prefill logits within
  float32 tolerance |diff| <= 1e-5 * (1 + |ref|), and equal greedy ids,
  with every step's top-2 logit margin asserted above that tolerance so
  that no near-tie can flip a token;
* continuous rows equal to wave rows within torch, under staggered
  admission and under a weight version published mid-flight;
* ``BlockAllocator`` invariants;
* ``python -m repro_torch.launch.serve --reduced --device cpu`` end to
  end, and the default device refusing to fall back to the CPU.
"""
import os
import subprocess
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.core.gspmd import GSPMDConfig, ShardingRules
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as JT
from repro.posttrain import GenerationEngine as JaxGenerationEngine
from repro_torch import bridge
from repro_torch.launch import serve
from repro_torch.models import transformer as TT
from repro_torch.posttrain.engine import (
    BlockAllocator, BlockAllocatorError, ContinuousGenerationEngine,
    GenerationEngine,
)

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup():
    cfg = get_reduced("qwen-1.5b")
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu")
    return cfg, params, tparams


def _prompts(n, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(1, vocab, size=(n, s)) \
        .astype(np.int32)


def _wave(cfg, tparams, prompts, gen_steps):
    engine = GenerationEngine(cfg, device="cpu")
    return engine.generate(tparams, prompts, gen_steps).generated


# ===========================================================================
# wave engine against the JAX engine
# ===========================================================================
def test_wave_generate_matches_jax(setup):
    cfg, params, tparams = setup
    B, S, G = 4, 12, 8
    prompts = _prompts(B, S, cfg.vocab_size, seed=1)

    mesh = make_host_mesh()
    gcfg = GSPMDConfig(rules=ShardingRules(), block_kv=64)
    jeng = JaxGenerationEngine(cfg, mesh, gcfg)
    jbatch = {"tokens": jnp.asarray(prompts),
              "positions": jnp.arange(S)[None].repeat(B, 0)}
    jlogits, _ = jeng.prefill(params, jbatch, jeng.init_cache(B, S + G))
    jgen = np.asarray(jeng.generate(params, prompts, G).generated)

    engine = GenerationEngine(cfg, device="cpu")
    batch = engine.prompt_batch(prompts)
    logits, cache = engine.prefill(tparams, batch,
                                   engine.init_cache(B, S + G))
    ref = np.asarray(jlogits, np.float32)
    err = np.abs(logits.numpy() - ref)
    assert (err <= TOL * (1 + np.abs(ref))).all(), float(err.max())

    # greedy decode by hand, keeping every step's logits for the margins
    steps = [logits[:, -1]]
    tok = logits[:, -1].argmax(-1)[:, None]
    for i in range(G - 1):
        logits, cache = engine.decode(tparams, cache, tok, S + i)
        steps.append(logits[:, -1])
        tok = logits[:, -1].argmax(-1)[:, None]
    top2 = torch.stack(steps, 1).topk(2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    assert margin > 2 * TOL * (1 + float(top2.abs().max())), margin

    tgen = engine.generate(tparams, prompts, G).generated
    np.testing.assert_array_equal(tgen, jgen)


# ===========================================================================
# continuous rows equal wave rows, within torch
# ===========================================================================
def test_continuous_matches_wave_with_staggered_admission(setup):
    """6 mixed-length requests over 3 slots: retirement frees blocks that
    admit queued requests mid-decode, and every request's tokens equal
    the wave engine's row."""
    cfg, _, tparams = setup
    S, G, slots, n = 8, 8, 3, 6
    prompts = _prompts(n, S, cfg.vocab_size, seed=2)
    stops = [S + g for g in (8, 3, 5, 2, 8, 4)]
    engine = ContinuousGenerationEngine(cfg, slots=slots, max_len=S + G,
                                        block_size=4, device="cpu")
    engine.publish(tparams, 0)
    for b in range(n):
        engine.submit(prompts[b], G, stop_length=stops[b])
    seen_active = 0
    while True:
        assert engine.active <= slots
        assert engine.allocator.assigned_blocks <= engine.allocator.num_blocks
        seen_active = max(seen_active, engine.active)
        if not engine.step():
            break
    done = engine.run()
    assert seen_active == slots
    assert engine.prefills == n
    assert sorted(c.rid for c in done) == list(range(n))
    assert engine.allocator.free_blocks == engine.allocator.num_blocks
    wave = _wave(cfg, tparams, prompts, G)
    for c in done:
        g = stops[c.rid] - S
        np.testing.assert_array_equal(c.generated, wave[c.rid, :g])
        assert c.finish_reason == "stop_length"
        np.testing.assert_array_equal(c.sequence[:S], prompts[c.rid])


def test_continuous_version_pinning(setup):
    """A version published mid-flight reaches only requests admitted after
    it; a step that mixes versions decodes each slot under its own, and
    every request equals the wave row under its pinned weights."""
    cfg, _, p0 = setup
    p1 = TT.init_params(cfg, torch.Generator().manual_seed(5))
    S, G, n = 6, 6, 4
    prompts = _prompts(n, S, cfg.vocab_size, seed=3)
    engine = ContinuousGenerationEngine(cfg, slots=2, max_len=S + G,
                                        block_size=4, device="cpu")
    engine.publish(p0, 0)
    engine.submit(prompts[0], G)
    engine.submit(prompts[1], 2)
    engine.step()
    engine.step()
    engine.publish(p1, 1)
    with pytest.raises(ValueError, match="must increase"):
        engine.publish(p1, 1)
    engine.submit(prompts[2], G)
    engine.submit(prompts[3], 3)
    done = {c.rid: c for c in engine.run()}
    assert [done[r].weight_version for r in range(n)] == [0, 0, 1, 1]
    # request 2 took request 1's slot while request 0 still ran on v0
    assert done[2].admitted_step < done[0].finished_step
    for rid, params in ((0, p0), (1, p0), (2, p1), (3, p1)):
        wave = _wave(cfg, params, prompts[rid:rid + 1], G)
        g = len(done[rid].generated)
        np.testing.assert_array_equal(done[rid].generated, wave[0, :g])
    assert set(engine._params) == {1}  # v0 dropped once nothing pins it


def test_continuous_eos_and_queue_rules(setup):
    cfg, _, tparams = setup
    S, G = 6, 6
    prompts = _prompts(2, S, cfg.vocab_size, seed=4)
    first = int(_wave(cfg, tparams, prompts[:1], 1)[0, 0])
    engine = ContinuousGenerationEngine(cfg, slots=1, max_len=S + G,
                                        device="cpu")
    with pytest.raises(RuntimeError, match="publish"):
        engine.submit(prompts[0], G)
    engine.publish(tparams, 0)
    with pytest.raises(ValueError, match="max_len"):
        engine.submit(prompts[0], G + 1)
    engine.submit(prompts[0], G, eos_id=first)
    engine.submit(prompts[1], 2)
    done = engine.run()
    assert [c.finish_reason for c in done] == ["eos", "max_new"]
    assert len(done[0].generated) == 1 and engine.steps == 1


def test_continuous_refuses_trace_recorder(setup):
    # the engine now takes a trace recorder; a recorder does not get a
    # family other than dense past the continuous engine's refusal
    from repro_torch.configs import get_reduced
    from repro_torch.sim.trace import TraceRecorder
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContinuousGenerationEngine(get_reduced("mamba2-2.7b"), slots=1,
                                   max_len=8, device="cpu",
                                   trace=TraceRecorder())


# ===========================================================================
# BlockAllocator invariants
# ===========================================================================
def _run_schedule(alloc, ops):
    live = {}
    for op in ops:
        if op[0] == "alloc":
            _, size, owner = op
            need = alloc.blocks_for(size)
            if owner in live or not alloc.can_alloc(need):
                continue
            live[owner] = alloc.alloc(need, owner)
        elif live:
            owner = sorted(live)[op[1] % len(live)]
            alloc.free(live.pop(owner), owner)
        alloc.check()
        assert alloc.assigned_blocks == sum(len(t) for t in live.values())
        assert alloc.free_blocks + alloc.assigned_blocks == alloc.num_blocks


@pytest.mark.parametrize("seed", range(4))
def test_allocator_seeded_schedules(seed):
    rng = np.random.default_rng(seed)
    ops = [("alloc", int(rng.integers(1, 200)), int(rng.integers(0, 50)))
           if rng.random() < 0.6 else ("free", int(rng.integers(0, 1000)))
           for _ in range(300)]
    _run_schedule(BlockAllocator(int(rng.integers(1, 40)),
                                 int(rng.integers(1, 32))), ops)


def test_allocator_rejects_misuse():
    alloc = BlockAllocator(4, 8)
    assert alloc.blocks_for(0) == 1 and alloc.blocks_for(17) == 3
    t = alloc.alloc(2, owner=1)
    with pytest.raises(BlockAllocatorError, match="owned by"):
        alloc.free(t, owner=2)
    alloc.free(t, owner=1)
    with pytest.raises(BlockAllocatorError, match="double free"):
        alloc.free(t, owner=1)
    with pytest.raises(BlockAllocatorError, match="requested"):
        alloc.alloc(5, owner=3)
    with pytest.raises(BlockAllocatorError, match="non-positive"):
        alloc.alloc(0, owner=3)
    with pytest.raises(ValueError):
        BlockAllocator(0, 8)
    alloc.check()


# ===========================================================================
# the CLI
# ===========================================================================
@pytest.mark.parametrize("extra,expect", [
    ([], "sample output ids"),
    (["--continuous", "--requests", "5", "--arch", "gemma2-9b"],
     "all freed: True"),
])
def test_serve_cli_on_cpu(extra, expect):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen-1.5b", "--reduced", "--device", "cpu", "--prompt-len", "16",
         "--gen", "6", *extra],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert expect in proc.stdout


def test_serve_run_summary_counts():
    args = serve.parse_args(["--arch", "qwen-1.5b", "--reduced", "--device",
                             "cpu", "--batch", "2", "--prompt-len", "8",
                             "--gen", "4", "--quiet"])
    summary = serve.run(args)
    assert (summary["prefill_calls"], summary["decode_steps"]) == (1, 3)
    assert summary["generated"].shape == (2, 4) and summary["ids_in_vocab"]


def test_default_device_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve.parse_args(["--arch", "qwen-1.5b", "--reduced"])
    assert args.device == "cuda" and args.dtype == "float32"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run(args)


@pytest.mark.parametrize("flag", [["--data-axis", "2"],
                                  ["--model-axis", "2", "--data-axis", "1"],
                                  ["--model-axis", "2"]])
def test_unported_flags_exit_with_error(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        serve.parse_args(["--reduced", "--device", "cpu", *flag])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not yet ported" in err or "one card" in err
