"""``python -m repro_torch.launch.posttrain`` on the CPU.

* The JAX driver ``repro.launch.posttrain`` in subprocesses on two host
  devices against the port's driver with two ranks, reduced qwen-1.5b:
  SFT (the loader's waves) and GRPO with engine rollouts and ODC pushes,
  2 iterations.  The two draw their weights differently, so only what
  does not depend on them is compared, row by row: the ``--metrics``
  header, the metric names, every ``comm.*`` row (the train step's
  gathers and scatters and, under GRPO, one push a version), and the
  ``posttrain.rollouts``, ``posttrain.staleness`` and
  ``posttrain.buffer_depth`` values (under SFT also ``posttrain.tokens``,
  the loader's token count).
* The CLI end to end (``--rollout engine``, ``continuous``, SFT) with
  ``--trace`` and ``--metrics``: the files read back through the port's
  ``read_trace`` and ``read_jsonl``, their lanes, the push bytes per push
  against ``push_comm_sites``.
* Refusals: ``--config`` (the tuner), ``--model-axis`` > 1, ``--comm cp``,
  and the ``--comm`` / ``--schedule`` / family combinations the train
  driver refuses; the default device refusing to fall back to the CPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import posttrain
from repro_torch.obs.metrics import metric_names, read_jsonl
from repro_torch.sim.trace import read_trace

REPO = Path(__file__).resolve().parents[1]
ARCH = "qwen-1.5b"
COMMON = ["--arch", ARCH, "--reduced", "--iters", "2", "--seed", "0"]
# task: the flags both drivers take
JAX_CASES = {
    "sft": ["--task", "sft", "--staleness", "0"],
    "grpo-engine": ["--task", "grpo", "--rollout", "engine", "--staleness",
                    "1", "--comm", "odc"],
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("posttrain")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2 "
                         "--xla_cpu_multi_thread_eigen=false")
    procs = {}
    for case, flags in JAX_CASES.items():
        out = d / f"{case}.jsonl"
        procs[case] = (subprocess.Popen(
            [sys.executable, "-m", "repro.launch.posttrain", *COMMON, *flags,
             "--metrics", str(out)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            out)
    files = {}
    for case, (p, out) in procs.items():
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log
        files[case] = out
    return files


def _weight_free(rows, task):
    keep = {"posttrain.rollouts", "posttrain.staleness",
            "posttrain.buffer_depth"}
    if task == "sft":
        keep.add("posttrain.tokens")
    return [(r["step"], [m for m in r["metrics"]
                         if m["name"].startswith("comm.")
                         or m["name"] in keep]) for r in rows]


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_metrics_match_the_jax_driver(case, jax_runs, tmp_path):
    ours = tmp_path / "m.jsonl"
    posttrain.main([*COMMON, *JAX_CASES[case], "--device", "cpu",
                    "--data-axis", "2", "--metrics", str(ours), "--quiet"])
    tmeta, trows = read_jsonl(str(ours))
    jmeta, jrows = read_jsonl(str(jax_runs[case]))
    assert tmeta == jmeta
    assert metric_names(trows) == metric_names(jrows)
    task = JAX_CASES[case][1]
    assert _weight_free(trows, task) == _weight_free(jrows, task)
    if case == "grpo-engine":
        assert "comm.bytes_logical{backend=odc,op=push,tier=flat}" in \
            metric_names(trows)


def _lanes(path):
    return {e["args"]["name"] for e in read_trace(str(path))["traceEvents"]
            if e["ph"] == "M"}


@pytest.mark.parametrize("flags,lanes,pushes", [
    (["--rollout", "engine", "--comm", "odc"],
     {"generator", "push", "trainer"}, 2),
    (["--rollout", "continuous", "--comm", "collective", "--slots", "3"],
     {"generator", "push", "trainer", "slot0", "slot1", "slot2"}, 2),
    (["--task", "sft", "--staleness", "0"], {"generator", "trainer"}, 0),
])
def test_cli_writes_trace_and_metrics(flags, lanes, pushes, tmp_path,
                                      capsys):
    from repro_torch.posttrain.weight_push import push_comm_sites

    t, m = tmp_path / "t.json", tmp_path / "m.jsonl"
    argv = [*COMMON, "--iters", "3", "--staleness", "1", *flags, "--device",
            "cpu", "--trace", str(t), "--metrics", str(m)]
    args = posttrain.parse_args(argv)
    summary = posttrain.run(args)
    out = capsys.readouterr().out
    assert "done: " in out and f"pushes={pushes}" in out
    assert summary["pushes"] == pushes
    assert _lanes(t) == lanes
    meta, rows = read_jsonl(str(m))
    assert meta["driver"] == "launch.posttrain" and meta["world"] == 2
    assert [r["step"] for r in rows] == [0, 1, 2]
    vals = {x["name"]: x["value"] for x in rows[-1]["metrics"]
            if not x["labels"]}
    assert vals["posttrain.rollouts"] == sum(
        s["rollouts"] for s in summary["metrics"])
    assert vals["posttrain.staleness"] == summary["metrics"][-1]["staleness"]
    assert vals["posttrain.loss"] == summary["metrics"][-1]["loss"]
    if pushes:
        built = posttrain.build(posttrain.parse_args(argv))
        sites = push_comm_sites(built[1], built[2])
        pushed = sum(x["value"] for x in rows[-1]["metrics"]
                     if x["name"] == "comm.bytes_logical"
                     and x["labels"]["op"] == "push")
        assert pushed == pushes * sum((w - 1) * b for b, w, _ in sites)
    if "continuous" in flags:  # the collective's barrier push stalls
        assert summary["push_stall_s"] > 0
        assert vals["engine.admissions"] == 96.0


def test_cli_no_push_and_no_steps(capsys):
    summary = posttrain.run(posttrain.parse_args(
        [*COMMON, "--rollout", "engine", "--no-push", "--device", "cpu",
         "--iters", "1", "--quiet"]))
    assert summary["pushes"] == 0 and len(summary["metrics"]) == 1
    posttrain.main([*COMMON, "--iters", "0", "--device", "cpu"])
    assert "setup OK" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--config", "c.json"], ["--model-axis", "2"], ["--comm", "cp"],
    ["--comm", "hier", "--schedule", "overlap"],
    ["--comm", "pipe", "--arch", "grok-1-314b"],
    ["--comm", "hier", "--arch", "seamless-m4t-medium"],
    ["--comm", "hier", "--nodes", "2", "--data-axis", "3"]])
def test_driver_refuses_what_is_not_ported(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        posttrain.parse_args(["--reduced", "--device", "cpu", *flags])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not yet ported" in err or "do not split" in err


def test_driver_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = posttrain.parse_args(["--reduced", "--iters", "1"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        posttrain.run(args)
