"""The port's telemetry against the JAX package's, on the CPU.

* ``obs/metrics.py`` and ``sim/trace.py`` are copies of the originals
  (the copy rule); the copy of ``sim/timeline.py``'s timeline schema
  (``Event``, ``Lane``, ``Timeline``) is held to the original by its
  outputs: the same call sequence gives the same JSONL rows, snapshots,
  quantiles and Chrome-trace dict.  The two seed failures of
  ``tests/test_timeline.py`` are about the policies, which the copy does
  not hold; its outputs on the same events are the original's.
* ``CommBackend.comm_volume`` per backend against the reference's, every
  op, world and group (hier and pipe with their tiers).
* The ``comm.*`` rows of the train drivers' ``--metrics`` files, step by
  step: ``repro.launch.train`` in a subprocess on world-many host devices
  (as ``tests/test_torch_driver_parity.py`` runs it) against
  ``repro_torch.launch.train`` here, both from one JAX-format step-0
  checkpoint, for odc x minibatch, collective x layer, odc-overlap and
  pipe-int8: the reference records at trace time, once per gather site of
  its compiled step, and the port's ledger (``backend.record_step``) must
  count the same sites.
* The train driver's ``--trace``: host and trainer lanes, read back.
* The continuous engine's telemetry against the JAX engine's:
  ``publish(barrier=..., push_time=...)`` charges the push to
  ``push_stall_s`` and emits the same trace events, and a run of requests
  gives the same ``engine.*`` counters and gauges.
"""
import inspect
import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro.core import backend as JB
from repro.models import transformer as JT
from repro.obs import metrics as JM
from repro.optim import adamw_init as jinit
from repro.sim import timeline as JTL
from repro.sim import trace as JTR
from repro_torch.core import backend as TB
from repro_torch.core.ranks import Tiers
from repro_torch.launch import train as train_cli
from repro_torch.obs import metrics as TM
from repro_torch.sim import timeline as TTL
from repro_torch.sim import trace as TTR

REPO = Path(__file__).resolve().parents[1]
ARCH = "qwen-1.5b"
# --comm: (the port's flags, the JAX driver's flags, its devices)
COMM_CASES = {
    "odc": (["--data-axis", "2"], ["--data-axis", "2"], 2),
    "collective": (["--schedule", "layer", "--data-axis", "2"],
                   ["--schedule", "layer", "--data-axis", "2"], 2),
    "odc-overlap": (["--data-axis", "2"], ["--data-axis", "2"], 2),
    "pipe-int8": (["--pipe-stages", "2", "--data-axis", "4"],
                  ["--pipe-stages", "2"], 4),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ===========================================================================
# the copies
# ===========================================================================
def test_metrics_and_trace_are_copies():
    src = REPO / "src"
    assert (src / "repro_torch/obs/metrics.py").read_text() == \
        (src / "repro/obs/metrics.py").read_text()
    ours = (src / "repro_torch/sim/trace.py").read_text()
    theirs = (src / "repro/sim/trace.py").read_text()
    assert ours == theirs.replace("from repro.sim.timeline import",
                                  "from repro_torch.sim.timeline import")
    for name in ("Event", "Lane", "Timeline"):
        assert inspect.getsource(getattr(TTL, name)) == \
            inspect.getsource(getattr(JTL, name))


def _drive_registry(M, path):
    """One call sequence through a metrics module; returns its snapshots,
    quantiles, totals and names."""
    reg = M.MetricsRegistry(meta={"driver": "test", "world": 2})
    reg.attach_jsonl(str(path))
    out = []
    with M.recording(reg):
        for step in range(3):
            reg.counter("comm.messages", backend="odc", op="gather",
                        tier="flat").inc(3.0 + step)
            reg.gauge("train.loss").set(1.5 / (step + 1))
            h = reg.histogram("comm.message_bytes", backend="odc",
                              op="gather", tier="flat")
            h.observe(4096.0 * (step + 1), 2.0)
            h.observe(2.0 ** 50)  # overflow bucket
            with M.program("train_step"):
                reg.counter("comm.bytes_wire", op="scatter").inc_per_step(
                    10.0 * (step + 1))
                with M.trace_scale(4):
                    reg.histogram("comm.message_bytes", op="scatter") \
                        .observe_per_step(512.0, 1.0)
            with M.suppressed():
                assert M.active() is None
            reg.counter("comm.bytes_wire", op="gather").inc_per_step(7.0)
            out.append(reg.step())
            out.append((h.quantile(0.5), h.quantile(0.99),
                        reg.total("comm.bytes_wire"),
                        reg.total("comm.bytes_wire", op="gather")))
        with pytest.raises(ValueError):
            reg.counter("x").inc(-1.0)
        with pytest.raises(ValueError):
            reg.histogram("y").observe(1.0, -1.0)
    assert M.active() is None
    reg.close()
    meta, rows = M.read_jsonl(str(path))
    out += [meta, rows, sorted(M.metric_names(rows)),
            sorted(M.metric_names(rows, kind="counter", prefix="comm."))]
    return out


def test_metrics_registry_matches_reference(tmp_path):
    ours = _drive_registry(TM, tmp_path / "t.jsonl")
    theirs = _drive_registry(JM, tmp_path / "j.jsonl")
    assert ours == theirs
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()


def _drive_timeline(TL, TR):
    tl = TL.Timeline(source="real", meta={"driver": "test"})
    a = tl.lane("trainer")
    a.advance(1.25, "compute", "step 0")
    a.wait(2.0, "barrier", "minibatch barrier")
    a.block(1.5, [("compute", 1.0, "mb0"), ("comm", 0.25, "odc wire"),
                  ("comm", 0.0, "empty")])
    a.mark("gate", "cleared")
    g = tl.lane("generator")
    g.place(0.5, 0.75, "decode", "wave 0")
    g.place(1.5, 0.0, "decode", "instant")
    g.wait(3.0, "gate", "staleness gate")
    tl.lane("push").place(0.25, 0.125, "push", "weights v0")
    tl.count("comm wire bytes", 0.5, 100.0)
    tl.count("comm wire bytes", 2.5, 300.0)
    with pytest.raises(ValueError):
        a.advance(1.0, "nap")
    quiet = TL.Timeline(record=False)
    quiet.lane("dev0").advance(2.0, "compute")
    return (TR.chrome_trace(tl, extra_meta={"k": 1}), tl.makespan,
            tl.idle_breakdown(), {ln.name: ln.kind_totals()
                                  for ln in tl.lanes},
            quiet.makespan, quiet.idle_breakdown(),
            [ln.events for ln in quiet.lanes])


def test_timeline_and_chrome_trace_match_reference(tmp_path):
    ours = _drive_timeline(TTL, TTR)
    theirs = _drive_timeline(JTL, JTR)
    assert ours[0] == theirs[0]
    assert ours[1:] == theirs[1:]
    assert TTL.EVENT_KINDS == JTL.EVENT_KINDS
    assert TTL.BUSY_KINDS == JTL.BUSY_KINDS


def test_trace_recorder_writes_what_read_trace_reads(tmp_path):
    rec = TTR.TraceRecorder(meta={"driver": "test"})
    with TTR.maybe_span(rec, "trainer", "compute", "step 0"):
        pass
    with TTR.maybe_span(None, "trainer", "compute", "no-op"):
        pass
    rec.event("push", "push", 0.0, 0.5, "weights v0")
    rec.instant("generator", "decode", "tick")
    rec.count("queue depth", 3.0)
    path = rec.write(str(tmp_path / "t.json"))
    got = TTR.read_trace(path)
    want = JTR.read_trace(path)
    assert got == want
    lanes = {e["args"]["name"] for e in got["traceEvents"]
             if e["ph"] == "M"}
    assert lanes == {"trainer", "push", "generator"}
    assert got["otherData"]["source"] == "real"
    assert got["otherData"]["driver"] == "test"


# ===========================================================================
# comm volume per backend
# ===========================================================================
@pytest.mark.parametrize("name", ["collective", "odc", "odc-overlap", "cp",
                                  "hier", "pipe", "pipe-int8"])
def test_comm_volume_matches_reference(name):
    ours, theirs = TB.get_backend(name), JB.get_backend(name)
    assert ours.push_blocks_trainer == theirs.push_blocks_trainer
    for tier in ("flat", "intra", "inter"):
        assert ours.wire_factor(tier) == theirs.wire_factor(tier)
    for op in ("gather", "scatter", "push"):
        for world in (1, 2, 3, 4, 8):
            for group in (None, 1, 2, 4, 8):
                for shard in (0.0, 4.0, 1000.0, 3.5e6):
                    assert ours.comm_volume(op, shard, world, group) == \
                        theirs.comm_volume(op, shard, world, group), \
                        (op, world, group, shard)


@pytest.mark.parametrize("name", ["odc", "collective", "hier", "pipe-int8"])
def test_record_comm_matches_reference(name):
    ours, theirs = TB.get_backend(name), JB.get_backend(name)
    if ours.two_tier:
        ours = ours.on(Tiers(2, 2))
    rows = []
    for be, M in ((ours, TM), (theirs, JM)):
        reg = M.MetricsRegistry()
        with M.recording(reg):
            be.record_comm("push", 65536.0, world=4, group=2, scale=3.0)
            be.record_comm("gather", 256.0, world=4, group=4)
            be.record_comm("scatter", 512.0, world=1)
        rows.append(reg.snapshot(0))
    assert rows[0] == rows[1]
    # recording off: nothing happens
    ours.record_comm("gather", 1.0, world=2)


# ===========================================================================
# the train drivers' comm rows, step by step
# ===========================================================================
@pytest.fixture(scope="module")
def jax_metrics(tmp_path_factory):
    """The JAX driver's --metrics file of each COMM_CASES entry, from one
    step-0 checkpoint, the runs in parallel."""
    d = tmp_path_factory.mktemp("obs")
    ckpt = d / "ckpt"
    cfg = jconfigs.get_reduced(ARCH)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    jckpt.save_checkpoint(str(ckpt), 0, {"params": params,
                                         "opt": jinit(params)})
    procs = {}
    for comm, (_, flags, devices) in COMM_CASES.items():
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=str(REPO / "src"),
                   XLA_FLAGS=f"--xla_force_host_platform_device_count="
                             f"{devices} --xla_cpu_multi_thread_eigen=false")
        out = d / f"{comm}.jsonl"
        cmd = [sys.executable, "-m", "repro.launch.train", "--arch", ARCH,
               "--reduced", "--steps", "2", "--seed", "0", "--ckpt-dir",
               str(ckpt), "--resume", "--comm", comm, *flags, "--metrics",
               str(out)]
        procs[comm] = (subprocess.Popen(
            cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    files = {}
    for comm, (p, out) in procs.items():
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log
        files[comm] = out
    return str(ckpt), files


def _comm_rows(path):
    meta, rows = TM.read_jsonl(str(path))
    return meta, [(r["step"], [m for m in r["metrics"]
                               if m["name"].startswith("comm.")])
                  for r in rows]


@pytest.mark.parametrize("comm", list(COMM_CASES))
def test_train_driver_comm_rows_match_jax_driver(comm, jax_metrics,
                                                 tmp_path):
    ckpt, files = jax_metrics
    flags = COMM_CASES[comm][0]
    ours = tmp_path / "m.jsonl"
    trace = tmp_path / "t.json"
    summary = train_cli.run(train_cli.parse_args(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
         "--seed", "0", "--ckpt-dir", ckpt, "--resume", "--comm", comm,
         *flags, "--metrics", str(ours), "--trace", str(trace),
         "--quiet"]))
    tmeta, trows = _comm_rows(ours)
    jmeta, jrows = _comm_rows(files[comm])
    assert tmeta == jmeta
    assert [s for s, _ in trows] == [0, 1]
    assert trows == jrows
    assert trows[1][1], "no comm row recorded"
    # the train rows: the same names, loss as the driver reports it
    _, rows = TM.read_jsonl(str(ours))
    names = {m["name"] for m in rows[0]["metrics"]}
    assert {"train.loss", "train.step_s", "train.tokens",
            "train.samples"} <= names
    loss = [m["value"] for m in rows[1]["metrics"]
            if m["name"] == "train.loss"]
    assert loss == [summary["losses"][1]]
    tr = TTR.read_trace(str(trace))
    lanes = {e["args"]["name"] for e in tr["traceEvents"] if e["ph"] == "M"}
    assert lanes == {"host", "trainer"}
    steps = [e for e in tr["traceEvents"] if e.get("name", "").startswith(
        "train step")]
    assert len(steps) == 2
    assert tr["otherData"]["comm"] == TB.get_backend(comm).name


def test_train_driver_without_telemetry_records_nothing(tmp_path):
    assert TM.active() is None
    train_cli.run(train_cli.parse_args(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "1",
         "--data-axis", "2", "--quiet"]))
    assert TM.active() is None
    assert not list(tmp_path.iterdir())


# ===========================================================================
# the continuous engine's telemetry against the JAX engine's
# ===========================================================================
@pytest.fixture(scope="module")
def engines():
    from repro.core.gspmd import GSPMDConfig, ShardingRules
    from repro.launch.mesh import make_host_mesh
    from repro.posttrain import ContinuousGenerationEngine as JEngine
    from repro_torch import bridge
    from repro_torch.posttrain.engine import ContinuousGenerationEngine

    cfg = jconfigs.get_reduced(ARCH)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu")
    mesh = make_host_mesh(data=1)
    gcfg = GSPMDConfig(rules=ShardingRules(), block_kv=64)

    def make(slots, max_len, trace):
        j = JEngine(cfg, mesh, gcfg, slots=slots, max_len=max_len,
                    trace=trace[0])
        t = ContinuousGenerationEngine(cfg, slots=slots, max_len=max_len,
                                       device="cpu", trace=trace[1])
        return j, t

    return cfg, params, tparams, make


def _events(rec):
    return sorted((ln.name, e.kind, e.start, e.duration, e.name)
                  for ln in rec.timeline.lanes for e in ln.events)


@pytest.mark.parametrize("barrier", [True, False])
def test_publish_charges_the_push_like_the_jax_engine(engines, barrier):
    cfg, params, tparams, make = engines
    recs = (JTR.TraceRecorder(), TTR.TraceRecorder())
    j, t = make(3, 16, recs)
    for eng, p in ((j, params), (t, tparams)):
        eng.publish(p, 0)
        eng.publish(p, 1, barrier=barrier, push_time=0.25)
        eng.publish(p, 2, barrier=barrier, push_time=0.0)
        with pytest.raises(ValueError, match="versions must increase"):
            eng.publish(p, 2)
    assert t.push_stall_s == j.push_stall_s == (0.75 if barrier else 0.0)
    assert _events(recs[1]) == _events(recs[0])
    lanes = {ln.name for ln in recs[1].timeline.lanes}
    assert lanes == ({"push", "slot0", "slot1", "slot2"} if barrier
                     else {"push"})


def test_engine_counters_and_gauges_match_the_jax_engine(engines):
    cfg, params, tparams, make = engines
    j, t = make(2, 24, (None, None))
    prompts = np.random.default_rng(3).integers(
        1, cfg.vocab_size, size=(5, 8)).astype(np.int32)
    snaps = []
    for eng, p, M in ((j, params, JM), (t, tparams, TM)):
        reg = M.MetricsRegistry()
        with M.recording(reg):
            eng.publish(p, 0)
            for b, budget in enumerate((3, 9, 1, 5, 7)):
                eng.submit(prompts[b], budget)
            assert eng.queued == 5
            while eng.step():
                snaps.append((eng is t, reg.snapshot(eng.steps)))
            eng.run()
        snaps.append((eng is t, reg.snapshot(-1)))
    theirs = [s for mine, s in snaps if not mine]
    ours = [s for mine, s in snaps if mine]
    assert ours == theirs
    names = {m["name"] for m in ours[-1]["metrics"]}
    assert names == {"engine.admissions", "engine.retirements",
                     "engine.decode_steps", "engine.queue_depth",
                     "engine.active_slots", "engine.kv_free_blocks"}
    assert [c.generated.tolist() for c in sorted(t.completed,
                                                 key=lambda c: c.rid)] == \
        [c.generated.tolist() for c in sorted(j.completed,
                                              key=lambda c: c.rid)]


def test_serve_driver_writes_metrics_and_trace(tmp_path):
    from repro_torch.launch import serve

    m, tr = tmp_path / "m.jsonl", tmp_path / "t.json"
    serve.run(serve.parse_args(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--continuous",
         "--requests", "4", "--gen", "6", "--prompt-len", "8",
         "--trace", str(tr), "--metrics", str(m), "--quiet"]))
    meta, rows = TM.read_jsonl(str(m))
    assert meta["driver"] == "launch.serve" and meta["mode"] == "continuous"
    vals = {x["name"]: x["value"] for x in rows[0]["metrics"]}
    assert vals["engine.admissions"] == vals["engine.retirements"] == 4.0
    assert vals["serve.requests_done"] == 4.0
    assert vals["engine.decode_steps"] == vals["serve.decode_steps"] > 0
    lanes = {e["args"]["name"] for e in TTR.read_trace(str(tr))[
        "traceEvents"] if e["ph"] == "M"}
    assert {"slot0", "slot1", "slot2", "slot3"} <= lanes
    wave = tmp_path / "w.jsonl"
    serve.run(serve.parse_args(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--gen", "4",
         "--prompt-len", "8", "--batch", "2", "--metrics", str(wave),
         "--quiet"]))
    _, rows = TM.read_jsonl(str(wave))
    vals = {x["name"]: x["value"] for x in rows[0]["metrics"]}
    assert vals["serve.generated_tokens"] == 2 * 3
    assert set(vals) == {"serve.prefill_s", "serve.decode_s",
                         "serve.generated_tokens"}
