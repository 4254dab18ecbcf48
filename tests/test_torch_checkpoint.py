"""The port's checkpoints, on the CPU.

* Save -> resume through the train driver (reduced qwen, 2 ranks, the
  overlap schedule and ODC x minibatch; reduced mamba2, the ssm family,
  under ODC x minibatch; reduced zamba2, the hybrid family, under the
  overlap schedule): 2 steps and a checkpoint, then a
  resumed run to step 3, against 3 steps run straight.  Tolerance: none;
  the losses and final parameters are bitwise equal (the state round-trips
  exactly through float32 files, and the loader replays the skipped steps'
  token stream).  These runs use one CPU thread: with several, two runs of
  the same three steps on this CPU build can end with parameters a unit
  in the last place apart (a multithreaded kernel of the step sums in an
  order that varies from run to run), which no checkpoint could fix.
* Across the packages: a checkpoint written by
  ``repro.checkpoint.save_checkpoint`` loads into the port as the same
  tree, and one written by the port loads into the JAX package, bitwise,
  with the same file names, keys and manifest; for mamba2's tree too, and
  for zamba2's at 5 layers (the ``mamba``, ``mamba_tail`` and
  ``shared_attn`` groups).
"""
import json
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.models.config import reduced as jreduced
from repro.optim import adamw_init as jinit
from repro_torch import checkpoint as tckpt
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import fsdp
from repro_torch.core.ranks import RankGroup
from repro_torch.core.train_step import Trainer
from repro_torch.launch import train as train_cli
from repro_torch.models.config import reduced

ARCH = "qwen-1.5b"
MAMBA = "mamba2-2.7b"
HYBRID = "zamba2-1.2b"
# the hybrid state's depth: two super-layers at period 2 and a tail of one
HYBRID_LAYERS = 5


def _args(*extra, arch=ARCH):
    return train_cli.parse_args(["--arch", arch, "--reduced", "--device",
                                 "cpu", "--data-axis", "2", "--quiet",
                                 *extra])


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _save_then_resume(tmp_path, comm, arch=ARCH):
    ckpt = str(tmp_path / "ckpt")
    straight = train_cli.run(_args("--comm", comm, "--steps", "3",
                                   arch=arch), return_params=True)
    first = train_cli.run(_args("--comm", comm, "--steps", "2",
                                "--ckpt-dir", ckpt, "--ckpt-every", "2",
                                arch=arch))
    assert first["saved"] == [2]
    assert tckpt.latest_step(ckpt) == 2
    resumed = train_cli.run(_args("--comm", comm, "--steps", "3",
                                  "--ckpt-dir", ckpt, "--resume", arch=arch),
                            return_params=True)
    assert resumed["start_step"] == 2 and len(resumed["losses"]) == 1
    assert first["losses"] + resumed["losses"] == straight["losses"]
    for path in fsdp.tree_paths(straight["params"]):
        assert torch.equal(fsdp.get(straight["params"], path),
                           fsdp.get(resumed["params"], path)), path


@pytest.mark.parametrize("comm", ["odc-overlap", "odc"])
def test_save_then_resume_is_bitwise(tmp_path, comm, one_thread):
    _save_then_resume(tmp_path, comm)


def test_mamba_save_then_resume_is_bitwise(tmp_path, one_thread):
    _save_then_resume(tmp_path, "odc", MAMBA)


def test_hybrid_save_then_resume_is_bitwise(tmp_path, one_thread):
    _save_then_resume(tmp_path, "odc-overlap", HYBRID)


def test_resume_needs_a_directory_and_starts_fresh_without_one(tmp_path):
    with pytest.raises(SystemExit, match="--resume needs --ckpt-dir"):
        train_cli.run(_args("--resume", "--steps", "1"))
    empty = str(tmp_path / "none")
    fresh = train_cli.run(_args("--resume", "--ckpt-dir", empty,
                                "--steps", "1"))
    plain = train_cli.run(_args("--steps", "1"))
    assert fresh["start_step"] == 0 and fresh["losses"] == plain["losses"]
    assert tckpt.latest_step(empty) is None


def _cfgs(arch):
    """(JAX config, port config) of a checkpoint test's state."""
    if arch == HYBRID:
        return (jreduced(jconfigs.get_config(arch), num_layers=HYBRID_LAYERS),
                reduced(get_config(arch), num_layers=HYBRID_LAYERS))
    return jconfigs.get_reduced(arch), get_reduced(arch)


def _state(arch):
    cfg = _cfgs(arch)[0]
    params = JT.init_params(cfg, jax.random.PRNGKey(2))
    opt = jinit(params)
    # a state past step 0, so that m, v and step are not all zeros
    opt = {"m": jax.tree.map(lambda x: x * 0.5, params),
           "v": jax.tree.map(lambda x: x * x, params),
           "step": opt["step"] + 3}
    return {"params": params, "opt": opt}


@pytest.fixture(scope="module")
def jax_state():
    return _state(ARCH)


@pytest.fixture(scope="module")
def mamba_state():
    return _state(MAMBA)


@pytest.fixture(scope="module")
def hybrid_state():
    return _state(HYBRID)


def _assert_same(ours, ref):
    flat = jax.tree_util.tree_leaves_with_path(ref)
    for path, leaf in flat:
        keys = tuple(k.key for k in path)
        a, b = np.asarray(fsdp.get(ours, keys)), np.asarray(leaf)
        assert a.dtype == b.dtype and a.shape == b.shape, keys
        assert np.array_equal(a, b), keys


def _jax_to_port(tmp_path, state, arch):
    d = str(tmp_path)
    jckpt.save_checkpoint(d, 5, state)
    tr = Trainer(_cfgs(arch)[1], RankGroup.make(2, "cpu"))
    assert tckpt.latest_step(d) == 5
    tree = tckpt.load_checkpoint(d, 5, tr.state_like())
    _assert_same(tree, state)
    shards, opt = tr.restore(tree)
    back = tr.state_tree(shards, opt)
    _assert_same({"params": _np_tree(back["params"]),
                  "opt": {"m": _np_tree(back["opt"]["m"]),
                          "v": _np_tree(back["opt"]["v"]),
                          "step": back["opt"]["step"].numpy()}}, state)


def test_jax_checkpoint_loads_into_the_port(tmp_path, jax_state):
    _jax_to_port(tmp_path, jax_state, ARCH)


def test_mamba_jax_checkpoint_loads_into_the_port(tmp_path, mamba_state):
    _jax_to_port(tmp_path, mamba_state, MAMBA)


def test_hybrid_jax_checkpoint_loads_into_the_port(tmp_path, hybrid_state):
    assert "mamba_tail" in hybrid_state["params"]
    _jax_to_port(tmp_path, hybrid_state, HYBRID)


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _port_to_jax(tmp_path, state, arch):
    d_port, d_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    tr = Trainer(_cfgs(arch)[1], RankGroup.make(2, "cpu"))
    from repro_torch import bridge

    shards, opt = bridge.train_state_from_numpy(
        jax.tree.map(np.asarray, state["params"]),
        jax.tree.map(np.asarray, state["opt"]), tr)
    tckpt.save_checkpoint(d_port, 7, tr.state_tree(shards, opt))
    jckpt.save_checkpoint(d_jax, 7, state)
    assert sorted(os.listdir(d_port)) == sorted(os.listdir(d_jax))
    with open(os.path.join(d_port, "state_00000007.json")) as f:
        ours = json.load(f)
    with open(os.path.join(d_jax, "state_00000007.json")) as f:
        ref = json.load(f)
    assert ours == ref
    loaded = jckpt.load_checkpoint(d_port, 7, state)
    _assert_same(jax.tree.map(np.asarray, loaded), state)


def test_port_checkpoint_loads_into_jax(tmp_path, jax_state):
    _port_to_jax(tmp_path, jax_state, ARCH)


def test_mamba_port_checkpoint_loads_into_jax(tmp_path, mamba_state):
    _port_to_jax(tmp_path, mamba_state, MAMBA)


def test_hybrid_port_checkpoint_loads_into_jax(tmp_path, hybrid_state):
    _port_to_jax(tmp_path, hybrid_state, HYBRID)
