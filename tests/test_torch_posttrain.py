"""The port's post-training subsystem against the JAX package's, on the CPU.

Reduced qwen-1.5b, both sides from one set of JAX-drawn weights (through
``repro_torch.bridge``):

* ``RolloutBuffer``: the same operation sequences give the same pops,
  staleness records and errors (types and messages).
* ``GRPOTask`` (synthetic waves and the engines' seeded inputs) and
  ``SFTTask``: waves, plans and batch arrays bitwise.
* ``WeightPusher``: bitwise the trainer's parameters under collective,
  odc, odc-overlap, hier and pipe; under pipe-int8 bitwise the JAX
  ``make_weight_push``'s output on the same parameters (the int8 wire is
  not exact); ``push_comm_sites`` equal to the reference's.
* ``PostTrainPipeline``, 3 iterations of synthetic GRPO at staleness 0
  and 1 against ``repro.posttrain.PostTrainPipeline``: each step's
  rollouts, staleness, microbatches and pushes equal, losses within 1e-5
  relative (the train step's engine-level bound,
  ``tests/test_torch_driver_parity.py``); staleness 0 bitwise the port's
  own synchronous loop; ``run(2); run(1)`` consumes ``run(3)``'s stream
  (the rows equal but for staleness, which can only be lower).
* Engine-backed and continuous rollouts (greedy), 3 iterations at
  staleness 1 with pushes: every wave's tokens and versions equal the
  JAX pipeline's.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import posttrain as JP
from repro.core.gspmd import GSPMDConfig, ShardingRules, make_train_step
from repro.launch.mesh import make_hier_mesh, make_host_mesh, make_pipe_mesh
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as jinit
from repro.posttrain import weight_push as JW
from repro_torch import bridge
from repro_torch.core.ranks import RankGroup
from repro_torch.core.train_step import Trainer
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.posttrain import buffer as TBUF
from repro_torch.posttrain import engine as TENG
from repro_torch.posttrain import tasks as TTASK
from repro_torch.posttrain import weight_push as TW
from repro_torch.posttrain.pipeline import PostTrainPipeline

ARCH = "qwen-1.5b"
LOSS_RTOL = 1e-5
LR = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def model():
    cfg = jconfigs.get_reduced(ARCH)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(model, tr):
    cfg, params = model
    return bridge.train_state_from_numpy(_np(params), _np(jinit(params)), tr)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.int32) if x.dtype == np.float32 else x


# ===========================================================================
# the buffer
# ===========================================================================
def _drive_buffer(mod):
    out = []

    def attempt(fn):
        try:
            r = fn()
        except Exception as e:  # noqa: BLE001 (compared across packages)
            out.append(("raise", type(e).__name__, str(e)))
            return None
        out.append(("ok", r))
        return r

    attempt(lambda: mod.RolloutBuffer(-1))
    buf = mod.RolloutBuffer(staleness=1)
    R = mod.Rollout
    attempt(lambda: buf.put([np.arange(3)]))  # raw needs a version
    buf.put([np.arange(3), np.arange(5)], version=0)
    buf.put([R(np.arange(2, dtype=np.int32), 0.5, 1),
             R(np.arange(4, dtype=np.int32), -0.5, 1)])
    attempt(lambda: buf.put([R(np.arange(2, dtype=np.int32), 0.1, 3)],
                            version=2))  # conflicting tags
    attempt(lambda: buf.pop(9, train_step=0))  # underflow
    attempt(lambda: buf.pop(2, train_step=3))  # too stale: left intact
    out.append(len(buf))
    for step, n in ((1, 1), (1, 2), (2, 1)):
        got = attempt(lambda: buf.pop(n, train_step=step))
        if got is not None:
            out.append([(r.tokens.tolist(), r.advantage, r.version, r.seq,
                         r.length) for r in got])
    out.append((len(buf), buf.ready(1), list(buf.staleness_seen),
                buf.max_staleness_seen))
    return out


def test_buffer_matches_reference():
    ours, theirs = _drive_buffer(TBUF), _drive_buffer(JP.buffer)
    # pops compare as plain values; raised errors by type name and text
    norm = lambda xs: [x if not (isinstance(x, tuple) and x[0] == "ok")
                       else ("ok", None) for x in xs]
    assert norm(ours) == norm(theirs)
    assert any(x[0] == "raise" and x[1] == "StalenessViolation"
               for x in ours if isinstance(x, tuple))


# ===========================================================================
# the tasks
# ===========================================================================
def _rollouts(wave):
    return [(r.tokens.tolist(), r.advantage, r.version) for r in wave]


def _batch_equal(tb, jb):
    assert set(tb) == set(jb)
    for k in tb:
        assert np.asarray(tb[k]).dtype == np.asarray(jb[k]).dtype, k
        assert np.array_equal(_bits(tb[k]), _bits(jb[k])), k


@pytest.mark.parametrize("variance", [1.0, 2.0])
def test_grpo_task_matches_reference(model, variance):
    cfg, _ = model
    kw = dict(vocab_size=cfg.vocab_size, prompts=3, group=4, max_len=96,
              max_tokens=128, seed=5, length_variance=variance)
    ours, theirs = TTASK.GRPOTask(**kw), JP.GRPOTask(**kw)
    assert ours.wave_size == theirs.wave_size == 12
    for it in range(3):
        for a, b in zip(ours._wave_inputs(it), theirs._wave_inputs(it)):
            assert np.array_equal(a, b)
        tw = ours.generate_wave(it, None, it)
        jw = theirs.generate_wave(it, None, it)
        assert _rollouts(tw) == _rollouts(jw)
        for world in (2, 4):
            tp, tb = ours.build_batch(tw, world)
            jp, jb = theirs.build_batch(jw, world)
            assert tp.assignments == jp.assignments
            _batch_equal(tb, jb)
            # signed advantages folded into the loss mask
            assert (np.asarray(tb["loss_mask"]) < 0).any()
    with pytest.raises(ValueError, match="token budget"):
        TTASK.GRPOTask(vocab_size=64, max_len=300, max_tokens=256)
    with pytest.raises(ValueError, match="GenerationEngine"):
        TTASK.GRPOTask(vocab_size=64, rollout_source="engine")
    with pytest.raises(ValueError, match="unknown rollout_source"):
        TTASK.GRPOTask(vocab_size=64, rollout_source="other")


@pytest.mark.parametrize("dataset", ["longalign", "aime"])
def test_sft_task_matches_reference(model, dataset):
    cfg, _ = model
    kw = dict(vocab_size=cfg.vocab_size, world=2, dataset=dataset,
              minibatch_per_device=3, max_tokens=256, max_len=200, seed=1)
    ours, theirs = TTASK.SFTTask(**kw), JP.SFTTask(**kw)
    for it in range(3):
        tw, jw = ours.generate_wave(it, None, 0), theirs.generate_wave(
            it, None, 0)
        assert _rollouts(tw) == _rollouts(jw)
        tp, tb = ours.build_batch(tw, 2)
        jp, jb = theirs.build_batch(jw, 2)
        assert tp.assignments == jp.assignments
        _batch_equal(tb, jb)


# ===========================================================================
# the weight push
# ===========================================================================
PUSH_CASES = {  # comm: (ranks, inter, the JAX mesh and its data rules)
    "collective": (2, 2, lambda: make_host_mesh(data=2), ShardingRules()),
    "odc": (2, 2, lambda: make_host_mesh(data=2), ShardingRules()),
    "odc-overlap": (2, 2, lambda: make_host_mesh(data=2), ShardingRules()),
    "hier": (4, 2, lambda: make_hier_mesh(nodes=2, device=2),
             ShardingRules(data=("node", "device"))),
    "pipe": (4, 2, lambda: make_pipe_mesh(stages=2, data=2),
             ShardingRules(data=("pipe", "data"))),
    "pipe-int8": (4, 2, lambda: make_pipe_mesh(stages=2, data=2),
                  ShardingRules(data=("pipe", "data"))),
}


def _jax_gcfg(comm, rules):
    return GSPMDConfig(rules=rules, comm=comm, block_kv=64,
                       pipe_stages=2 if comm.startswith("pipe") else 0)


@pytest.mark.parametrize("comm", list(PUSH_CASES))
def test_weight_push_matches_reference(model, comm):
    from repro_torch.obs import metrics as TM

    cfg, params = model
    n, inter, mesh_fn, rules = PUSH_CASES[comm]
    tr = Trainer(cfg, RankGroup.make(n, "cpu"), comm=comm, inter=inter)
    shards, _ = _port_state(model, tr)
    pusher = TW.WeightPusher(tr)
    reg = TM.MetricsRegistry()
    with TM.recording(reg):
        pushed = pusher.push(shards, 0)
        pusher.push(shards, 1)
    assert (pusher.version, pusher.pushes) == (1, 2)
    assert pusher.blocks_generator == (comm == "collective")
    mesh, gcfg = mesh_fn(), _jax_gcfg(comm, rules)
    if comm == "pipe-int8":  # the int8 wire: bitwise the reference's push
        with mesh:
            want = _np(JW.make_weight_push(cfg, mesh, gcfg)(params))
    else:  # an exact gather: bitwise the trainer's parameters
        want = tr.unshard(shards)
        assert all(np.array_equal(_bits(a), _bits(b)) for a, b in zip(
            _leaves(want), _leaves(_np(params))))
    got, ref = _leaves(pushed), _leaves(want)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert tuple(a.shape) == tuple(np.asarray(b).shape)
        assert np.array_equal(_bits(a.numpy()), _bits(b))
    if comm == "pipe-int8":  # and the wire did round some weight
        assert not all(np.array_equal(_bits(a.numpy()), _bits(b))
                       for a, b in zip(got, _leaves(_np(params))))
    sites = TW.push_comm_sites(tr, shards)
    assert sites == JW.push_comm_sites(cfg, mesh, gcfg)
    # two pushes charged: comm.bytes_logical{op=push} is twice the sites'
    logical = reg.total("comm.bytes_logical", op="push")
    assert logical == 2 * sum(
        v[2] for b, w, g in sites
        for v in tr.backend.comm_volume("push", b, w, g))


# ===========================================================================
# the pipeline, synthetic rollouts
# ===========================================================================
def _jax_pipeline(model, task, staleness, *, engine=None, live=None,
                  push=False):
    cfg, params = model
    mesh = make_host_mesh(data=2)
    gcfg = GSPMDConfig(rules=ShardingRules(), schedule="minibatch",
                       comm="odc", block_kv=64)
    step = jax.jit(make_train_step(cfg, mesh, gcfg, JAdamW(lr=LR)))
    pusher = JP.WeightPusher(cfg, mesh, gcfg) if push else None
    pipe = JP.PostTrainPipeline(task=task, step_fn=step, mesh=mesh, world=2,
                                staleness=staleness, pusher=pusher,
                                live_engine=live)
    return pipe, params, jinit(params)


def _port_pipeline(model, task, staleness, *, live=None, push=False):
    cfg, _ = model
    tr = Trainer(cfg, RankGroup.make(2, "cpu"), comm="odc",
                 opt_cfg=AdamWConfig(lr=LR))
    shards, opt = _port_state(model, tr)
    pusher = TW.WeightPusher(tr) if push else None
    pipe = PostTrainPipeline(task=task, step_fn=tr.step, world=2,
                             staleness=staleness, pusher=pusher,
                             live_engine=live)
    return pipe, shards, opt, tr


def _grpo_kw(cfg):
    return dict(vocab_size=cfg.vocab_size, prompts=4, group=4, max_len=96,
                max_tokens=128, seed=0)


ROW_KEYS = ("step", "rollouts", "staleness", "microbatches", "pushes")


@pytest.mark.parametrize("staleness", [0, 1])
def test_pipeline_synthetic_matches_reference(model, staleness):
    cfg, _ = model
    jpipe, jp, jo = _jax_pipeline(model, JP.GRPOTask(**_grpo_kw(cfg)),
                                  staleness)
    _, _, jrows = jpipe.run(3, jp, jo, verbose=False)
    tpipe, shards, opt, tr = _port_pipeline(
        model, TTASK.GRPOTask(**_grpo_kw(cfg)), staleness)
    _, _, trows = tpipe.run(3, shards, opt, verbose=False)
    assert [{k: r[k] for k in ROW_KEYS} for r in trows] == \
        [{k: r[k] for k in ROW_KEYS} for r in jrows]
    for a, b in zip(trows, jrows):
        # "tokens" sums the advantage-signed loss mask, in another order
        for k in ("loss", "tokens"):
            assert abs(a[k] - b[k]) <= LOSS_RTOL * abs(b[k]), (k, a, b)
    assert tpipe.buffer.staleness_seen == jpipe.buffer.staleness_seen
    assert tpipe.buffer.max_staleness_seen == staleness
    if staleness:
        return
    # staleness 0 is the synchronous alternating loop, bit for bit
    task = TTASK.GRPOTask(**_grpo_kw(cfg))
    shards, opt = _port_state(model, tr)
    for t in range(3):
        wave = task.generate_wave(t, shards, t)
        plan, batch = task.build_batch(wave, 2)
        shards, opt, m = tr.step(shards, opt, batch,
                                 [len(d) for d in plan.assignments])
        assert float(m["loss"]) == trows[t]["loss"]


def test_pipeline_run_is_reentrant(model):
    cfg, _ = model
    once, s, o, _ = _port_pipeline(model, TTASK.GRPOTask(**_grpo_kw(cfg)), 1)
    _, _, rows = once.run(3, s, o, verbose=False)
    twice, s, o, _ = _port_pipeline(model, TTASK.GRPOTask(**_grpo_kw(cfg)),
                                    1)
    s, o, first = twice.run(2, s, o, verbose=False)
    _, _, second = twice.run(1, s, o, verbose=False)
    # the same sample stream, generated fresher, never staler
    strip = lambda rs: [{k: v for k, v in r.items()
                         if k not in ("dt", "staleness")} for r in rs]
    assert strip(first + second) == strip(rows)
    assert all(a["staleness"] <= b["staleness"]
               for a, b in zip(first + second, rows))


# ===========================================================================
# engine-backed and continuous rollouts, with pushes
# ===========================================================================
class _Recording:
    """Wraps a task's generate_wave to keep every wave's tokens and
    versions."""

    def __init__(self, task):
        self.task, self.waves = task, []
        self.wave_size = task.wave_size

    def generate_wave(self, it, params, version):
        wave = self.task.generate_wave(it, params, version)
        self.waves.append([(r.tokens.tolist(), r.version) for r in wave])
        return wave

    def build_batch(self, rollouts, world):
        return self.task.build_batch(rollouts, world)


@pytest.mark.parametrize("source", ["engine", "continuous"])
def test_engine_rollouts_match_the_jax_pipeline(model, source):
    cfg, _ = model
    kw = dict(vocab_size=cfg.vocab_size, prompts=2, group=2, max_len=24,
              max_tokens=64, seed=0, prompt_len=8, rollout_source=source)
    mesh = make_host_mesh(data=2)
    gcfg = GSPMDConfig(rules=ShardingRules(), block_kv=64)
    if source == "engine":
        jeng = JP.GenerationEngine(cfg, mesh, gcfg)
        teng = TENG.GenerationEngine(cfg, device="cpu")
    else:
        jeng = JP.ContinuousGenerationEngine(cfg, mesh, gcfg, slots=2,
                                             max_len=24)
        teng = TENG.ContinuousGenerationEngine(cfg, slots=2, max_len=24,
                                               device="cpu")
    live = source == "continuous"
    jtask = _Recording(JP.GRPOTask(engine=jeng, **kw))
    jpipe, jp, jo = _jax_pipeline(model, jtask, 1, push=True,
                                  live=jeng if live else None)
    _, _, jrows = jpipe.run(3, jp, jo, verbose=False)
    ttask = _Recording(TTASK.GRPOTask(engine=teng, **kw))
    tpipe, shards, opt, _ = _port_pipeline(model, ttask, 1, push=True,
                                           live=teng if live else None)
    _, _, trows = tpipe.run(3, shards, opt, verbose=False)
    assert ttask.waves == jtask.waves
    assert [w[0][1] for w in ttask.waves] == [0, 0, 1]
    assert [r["pushes"] for r in trows] == [r["pushes"] for r in jrows] \
        == [1, 2, 2]
    assert [r["staleness"] for r in trows] == [0, 1, 1]
    for a, b in zip(trows, jrows):
        assert abs(a["loss"] - b["loss"]) <= LOSS_RTOL * abs(b["loss"])
    if live:
        assert teng.version == jeng.version == 1
        assert teng.push_stall_s == 0.0  # odc: no barrier
