"""The port's copies of the JAX package's numpy data and balance modules.

``repro_torch.data`` (lengths, packing, loader) and ``repro_torch.balance``
(cost, kk, strategies) are copies of ``repro.data`` / ``repro.balance``:
the port may import nothing of ``repro``.  Each copy's source equals its
original apart from import paths (``build_minibatch`` returns numpy and
refuses context-parallel plans: the port has no jax and no cp yet), and
for several datasets, seeds, rank counts and every strategy the train
driver offers, the copies give the same lengths, plans, tokens and packed
batches as the originals.  Tolerance: none (integer plans, copied
arrays).
"""
import os
from pathlib import Path

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np
import pytest

from repro.balance import cost as jcost
from repro.balance import strategies as jstrat
from repro.data import lengths as jlengths
from repro.data import loader as jloader
from repro.data import packing as jpacking
from repro_torch.balance import cost as tcost
from repro_torch.balance import strategies as tstrat
from repro_torch.data import lengths as tlengths
from repro_torch.data import loader as tloader
from repro_torch.data import packing as tpacking

SRC = Path(__file__).resolve().parents[1] / "src"
VERBATIM = ("data/lengths.py", "data/loader.py", "balance/cost.py",
            "balance/kk.py", "balance/strategies.py")
STRATEGIES = ("local_sort", "lb_micro", "lb_mini", "lb_mini_het", "lb_token")


@pytest.mark.parametrize("rel", VERBATIM)
def test_copies_are_verbatim(rel):
    ours = (SRC / "repro_torch" / rel).read_text()
    ref = (SRC / "repro" / rel).read_text()
    assert ours.replace("repro_torch.", "repro.") == ref


def test_packing_differs_only_in_build_minibatch():
    ours = (SRC / "repro_torch" / "data" / "packing.py").read_text()
    ref = (SRC / "repro" / "data" / "packing.py").read_text()
    head = ref.index("def build_minibatch(")
    assert ours[:ours.index("def build_minibatch(")] == ref[:head]


def _plans_equal(a, b):
    assert a.assignments == b.assignments
    assert a.strategy == b.strategy and a.cp == b.cp
    assert (a.profile is None) == (b.profile is None)
    if a.profile is not None:
        assert list(a.profile.speeds) == list(b.profile.speeds)


@pytest.mark.parametrize("dataset", ["longalign", "swesmith", "aime"])
@pytest.mark.parametrize("seed", [0, 3])
def test_lengths_match(dataset, seed):
    for max_len in (0, 512, 4096):
        a = tlengths.sample_lengths(dataset, 64, seed=seed, max_len=max_len)
        b = jlengths.sample_lengths(dataset, 64, seed=seed, max_len=max_len)
        assert np.array_equal(a, b)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("world", [2, 4])
def test_plans_match(strategy, world):
    for seed in (0, 1, 2):
        lens = jlengths.sample_lengths("longalign", 4 * world, seed=seed,
                                       max_len=4096)
        lens = np.minimum(lens, 4096)
        kw = {}
        if strategy == "lb_mini_het":
            kw = dict(profile=jcost.make_straggler_profile(
                "one_slow", world, slow_factor=2.0, seed=seed))
            tkw = dict(profile=tcost.make_straggler_profile(
                "one_slow", world, slow_factor=2.0, seed=seed))
        else:
            tkw = {}
        a = tstrat.make_plan(lens, world, 4096, strategy=strategy, **tkw)
        b = jstrat.make_plan(lens, world, 4096, strategy=strategy, **kw)
        _plans_equal(a, b)


@pytest.mark.parametrize("strategy", ["lb_mini", "local_sort", "lb_micro"])
@pytest.mark.parametrize("seed", [0, 5])
def test_loader_and_batches_match(strategy, seed):
    kw = dict(vocab_size=512, world_size=2, minibatch_per_device=4,
              max_tokens=256, strategy=strategy, max_len=200, seed=seed)
    ours = tloader.SyntheticSFTLoader("longalign", **kw)
    ref = jloader.SyntheticSFTLoader("longalign", **kw)
    for a, b in zip(ours.steps(3), ref.steps(3)):
        _plans_equal(a["plan"], b["plan"])
        assert np.array_equal(a["lengths"], b["lengths"])
        assert all(np.array_equal(x, y) for x, y in
                   zip(a["sample_tokens"], b["sample_tokens"]))
        tb = tpacking.build_minibatch(a["plan"], a["sample_tokens"], 256)
        jb = jpacking.build_minibatch(b["plan"], b["sample_tokens"], 256)
        assert sorted(tb) == sorted(jb)
        for k in jb:
            assert isinstance(tb[k], np.ndarray)
            assert tb[k].dtype == np.asarray(jb[k]).dtype
            assert np.array_equal(tb[k], np.asarray(jb[k]))


def test_pack_sequences_and_cp_refusal():
    toks = [np.arange(1, 6, dtype=np.int32), np.arange(7, 10, dtype=np.int32)]
    a = tpacking.pack_sequences(toks, 12)
    b = jpacking.pack_sequences(toks, 12)
    assert all(np.array_equal(a[k], b[k]) for k in b)
    lens = np.array([5000, 100, 120, 90, 80, 60, 70, 50])
    plan = tstrat.make_plan(lens, 2, 1024, strategy="lb_token", cp=2)
    assert plan.cp == 2
    toks = [np.ones(int(n), np.int32) for n in lens]
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tpacking.build_minibatch(plan, toks, 1024)
