"""The port's train driver and shard layout, on the CPU.

* ``RankGroup.make(0)``: one rank per visible card, refused on several.
* Each leaf is split on the data dim of ``gspmd.leaf_pspec``.
* The train driver's CLI on ``--device cpu --reduced``, its refusals of
  what is not ported, and its need of a card unless told ``--device
  cpu``.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np
import pytest
import torch

from repro_torch.core import fsdp
from repro_torch.core.ranks import RankGroup
from repro_torch.launch import train as train_cli
from torch_train_cases import ARCH, _get, _trainer, one_torch_thread  # noqa: F401


def test_data_axis_zero_keeps_ranks_on_one_card(monkeypatch):
    """n = 0 is one rank per visible device: one rank on one card, and a
    refusal on several, since ranks on separate cards are not ported
    (every CUDA rank lies on the current card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert RankGroup.make(0, "cuda").devices == (torch.device("cuda", 0),)
    assert RankGroup.make(2, "cuda").n == 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(NotImplementedError, match="separate cards"):
        RankGroup.make(0, "cuda")
    assert RankGroup.make(0, "cpu").n == 1


def test_shards_follow_the_jax_layout():
    """Each leaf is split on the data dim of ``gspmd.leaf_pspec`` and
    unsharding gives the tree back."""
    tr = _trainer(2, "odc", "minibatch")
    dims = tr.dims
    assert _get(dims, ("embed",)) == 1
    assert _get(dims, ("final_norm",)) == 0
    for name, d in (("wq", 1), ("wk", 1), ("wv", 1), ("wo", 2)):
        assert _get(dims, ("layers", "attn", name)) == d
    for name, d in (("w_gate", 1), ("w_up", 1), ("w_down", 2)):
        assert _get(dims, ("layers", "mlp", name)) == d
    assert _get(dims, ("layers", "attn_norm")) == 1
    assert fsdp.leaf_dim(("final_norm",), (5,), 2) is None  # replicated
    params = {"embed": torch.arange(24.0).reshape(4, 6),
              "final_norm": torch.arange(6.0)}
    shards = fsdp.shard_params(params, RankGroup.make(2, "cpu"))
    assert shards[1]["embed"].shape == (4, 3)
    back = fsdp.unshard_params(shards, fsdp.leaf_dims(params, 2))
    assert all(torch.equal(back[k], params[k]) for k in params)


def test_driver_cli_on_cpu(capsys):
    assert train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--data-axis", "2", "--steps", "2",
                           "--comm", "collective", "--schedule",
                           "layer"]) == 0
    out = capsys.readouterr().out
    assert "step    0 loss=" in out and "step    1 loss=" in out
    assert "done: " in out and "tok/s" in out and "kernel launches" in out
    summary = train_cli.run(train_cli.parse_args(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--data-axis", "2",
         "--steps", "2", "--cosine", "--warmup-steps", "1"]))
    assert len(summary["losses"]) == 2
    assert all(np.isfinite(summary["losses"]))
    assert all(np.isfinite(st["grad_norm"]) for st in summary["steps"])
    assert summary["world"] == 2
    # CPU tensors take the plain versions: no kernel launched
    assert set(summary["launches"].values()) == {0}


@pytest.mark.parametrize("flags", [
    ["--comm", "cp", "--arch", "grok-1-314b"],
    ["--comm", "hier", "--arch", "seamless-m4t-medium"],
    ["--config", "c.json"],
    ["--model-axis", "2"], ["--comm", "cp", "--schedule", "overlap"],
    ["--comm", "hier", "--schedule", "overlap"]])
def test_driver_refuses_what_is_not_ported(flags, capsys):
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--reduced", "--device", "cpu", *flags])
    assert "not yet ported" in capsys.readouterr().err


def test_driver_needs_a_card_unless_told_cpu():
    args = train_cli.parse_args(["--reduced", "--steps", "1"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.run(args)
