"""The two train drivers' per-step losses, from one checkpoint, on the CPU.

The drivers draw their random weights differently (``torch.Generator``
against ``jax.random.PRNGKey``), so they are started from one checkpoint
in the JAX package's format instead: ``JT.init_params`` and
``adamw_init`` of the reduced qwen-1.5b (and of the reduced mamba2-2.7b,
the ssm family, and the reduced zamba2-1.2b, the hybrid family, each
under every ``--comm`` but cp, which the port refuses for both: a
hybrid case checks the refusal), saved by
``repro.checkpoint.save_checkpoint`` at step 0 (checkpoints cross both
ways bitwise, ``tests/test_torch_checkpoint.py``).  Each driver then runs
two steps with ``--ckpt-dir ... --resume`` for every ``--comm`` the port
runs: ``python -m repro.launch.train`` in a subprocess on as many host
devices as the port's world (the JAX driver lays its mesh over every host
device under cp, hier and pipe; the port counts cp groups with
``--data-axis`` and puts every rank on one device, so the device count is
data x cp, nodes x devices or stages x data), reporting its losses
through ``--metrics``; ``repro_torch.launch.train`` in this process on
``--device cpu``.

Tolerance: 1e-5 relative per step, the engine-level bound of
``tests/test_torch_train_engine.py``: both start from the same bits, the
forwards agree to f32 rounding (other summation orders), and AdamW's
first steps move each weight by about lr * sign(g), so a gradient element
whose sign flips under another order moves the next loss by far less
than 1e-5 of itself.  For pipe-int8 the port's q8 rings are bitwise the
reference's on identical inputs; after step 0 the parameters differ by
f32 rounding, which can move a quantized value by one step of its chunk
(at most 1/127 of the chunk's absmax in one weight): the same bound.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.optim import adamw_init as jinit
from repro_torch.launch import train as train_cli

REPO = Path(__file__).resolve().parents[1]
ARCH = "qwen-1.5b"
MAMBA = "mamba2-2.7b"
HYBRID = "zamba2-1.2b"
STEPS = 2
LOSS_RTOL = 1e-5
# --comm: (the port's world flags, the JAX driver's flags, its devices)
CASES = {
    "collective": (["--schedule", "layer", "--data-axis", "2"],
                   ["--schedule", "layer", "--data-axis", "2"], 2),
    "odc": (["--data-axis", "2"], ["--data-axis", "2"], 2),
    "odc-overlap": (["--data-axis", "2"], ["--data-axis", "2"], 2),
    "cp": (["--cp", "2", "--data-axis", "1", "--strategy", "lb_token"],
           ["--cp", "2", "--strategy", "lb_token"], 2),
    "hier": (["--nodes", "2", "--data-axis", "4"], ["--nodes", "2"], 4),
    "pipe": (["--pipe-stages", "2", "--data-axis", "4"],
             ["--pipe-stages", "2"], 4),
    "pipe-int8": (["--pipe-stages", "2", "--data-axis", "4"],
                  ["--pipe-stages", "2"], 4),
}
MAMBA_CASES = [c for c in CASES if c != "cp"]
HYBRID_CASES = [c for c in CASES if c != "cp"]
# JAX driver processes running at once
CONCURRENT = 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _step0(tmp_path_factory, arch):
    """A step-0 train state of the reduced ``arch`` in the JAX format."""
    d = tmp_path_factory.mktemp("ckpt")
    cfg = jconfigs.get_reduced(arch)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    jckpt.save_checkpoint(str(d), 0, {"params": params,
                                      "opt": jinit(params)})
    return str(d)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _step0(tmp_path_factory, ARCH)


@pytest.fixture(scope="module")
def mamba_ckpt(tmp_path_factory):
    return _step0(tmp_path_factory, MAMBA)


@pytest.fixture(scope="module")
def hybrid_ckpt(tmp_path_factory):
    return _step0(tmp_path_factory, HYBRID)


def _common(ckpt, arch=ARCH):
    return ["--arch", arch, "--reduced", "--steps", str(STEPS), "--seed",
            "0", "--ckpt-dir", ckpt, "--resume"]


class _JaxRuns:
    """The JAX driver's runs of ``arch``, CONCURRENT at a time, in the
    order of ``comms``."""

    def __init__(self, ckpt, out, arch=ARCH, comms=tuple(CASES)):
        self.ckpt, self.out, self.arch = ckpt, out, arch
        self.pending = list(comms)
        self.running = {}

    def _start(self, comm):
        self.pending.remove(comm)
        _, flags, devices = CASES[comm]
        metrics = self.out / f"{comm}.jsonl"
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=str(REPO / "src"),
                   XLA_FLAGS=f"--xla_force_host_platform_device_count="
                             f"{devices} --xla_cpu_multi_thread_eigen=false")
        cmd = [sys.executable, "-m", "repro.launch.train",
               *_common(self.ckpt, self.arch), "--comm", comm, *flags,
               "--metrics",
               str(metrics)]
        self.running[comm] = (subprocess.Popen(
            cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), metrics)

    def _fill(self):
        while self.pending and len(self.running) < CONCURRENT:
            self._start(self.pending[0])

    def losses(self, comm):
        """The JAX driver's per-step losses under ``comm``, and its log."""
        if comm in self.pending:
            self._start(comm)
        self._fill()
        proc, metrics = self.running.pop(comm)
        log, _ = proc.communicate(timeout=900)
        self._fill()
        assert proc.returncode == 0, log
        losses = []
        with open(metrics) as f:
            for line in f:
                snap = json.loads(line)
                for row in snap.get("metrics", []):
                    if row["name"] == "train.loss":
                        losses.append(row["value"])
        return losses, log

    def close(self):
        for proc, _ in self.running.values():
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def jax_runs(ckpt, tmp_path_factory):
    runs = _JaxRuns(ckpt, tmp_path_factory.mktemp("metrics"))
    runs._fill()
    yield runs
    runs.close()


@pytest.fixture(scope="module")
def mamba_runs(mamba_ckpt, tmp_path_factory):
    runs = _JaxRuns(mamba_ckpt, tmp_path_factory.mktemp("metrics"), MAMBA,
                    MAMBA_CASES)
    runs._fill()
    yield runs
    runs.close()


@pytest.fixture(scope="module")
def hybrid_runs(hybrid_ckpt, tmp_path_factory):
    runs = _JaxRuns(hybrid_ckpt, tmp_path_factory.mktemp("metrics"), HYBRID,
                    HYBRID_CASES)
    runs._fill()
    yield runs
    runs.close()


def _check(arch, comm, ckpt, jax_runs, capsys):
    port_flags, _, _ = CASES[comm]
    summary = train_cli.run(train_cli.parse_args(
        [*_common(ckpt, arch), "--comm", comm, *port_flags, "--device",
         "cpu"]))
    out = capsys.readouterr().out
    assert f"resumed from {ckpt} at step 0" in out
    ref, log = jax_runs.losses(comm)
    assert f"resumed from {ckpt} at step 0" in log
    assert len(ref) == len(summary["losses"]) == STEPS
    for a, b in zip(summary["losses"], ref):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (comm, summary["losses"],
                                                  ref)


@pytest.mark.parametrize("comm", list(CASES))
def test_drivers_match_from_one_checkpoint(comm, ckpt, jax_runs, capsys):
    _check(ARCH, comm, ckpt, jax_runs, capsys)


@pytest.mark.parametrize("comm", MAMBA_CASES)
def test_mamba_drivers_match_from_one_checkpoint(comm, mamba_ckpt,
                                                 mamba_runs, capsys):
    _check(MAMBA, comm, mamba_ckpt, mamba_runs, capsys)


@pytest.mark.parametrize("comm", HYBRID_CASES)
def test_hybrid_drivers_match_from_one_checkpoint(comm, hybrid_ckpt,
                                                  hybrid_runs, capsys):
    _check(HYBRID, comm, hybrid_ckpt, hybrid_runs, capsys)


def test_hybrid_refuses_cp(hybrid_ckpt):
    port_flags, _, _ = CASES["cp"]
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        train_cli.run(train_cli.parse_args(
            [*_common(hybrid_ckpt, HYBRID), "--comm", "cp", *port_flags,
             "--device", "cpu"]))
