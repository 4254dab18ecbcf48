"""The port's overlap schedule against the JAX package's, on the CPU.

* The chained rings' plain versions (``odc_gather_layers_plain``,
  ``odc_scatter_accumulate_layers_plain``, which the kernel wrappers take
  on CPU tensors) against the Pallas chained kernels
  (``repro.kernels.ops.odc_gather_layers`` /
  ``odc_scatter_accumulate_layers``) in interpret mode under
  ``shard_map`` on the fake host devices, float32 and bfloat16, 2 and 4
  ranks, the scatter also in backward layer order and accumulating.
  Tolerance: none.  The gathers move data; both scatters add in the same
  hop order (``acc = arrived + own``), and bfloat16 sums are rounded from
  the same float32 sum on both sides.
* ``resolve``: ``odc-overlap`` (alias ``overlap``) implies the overlap
  schedule.
* Three train steps of odc x overlap and collective x overlap against
  ``gspmd.make_train_step(schedule='overlap', comm=...)``: losses within
  ``test_torch_train_engine``'s 1e-5 relative, and the final parameters within
  2 * lr * steps per element, the most that AdamW's update can move an
  element whose gradient sign differs between XLA's summation order and
  PyTorch's (a wrong gradient moves whole leaves by more).
* In the port, the overlap schedule computes the same step as the layer
  schedule: the same losses and gradients, bitwise (the same gathered
  values, the same rings per microbatch, the same accumulation order).
* The train driver with ``--comm odc-overlap`` on ``--device cpu``.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.core.gspmd import GSPMDConfig, make_train_step
from repro.data.loader import SyntheticSFTLoader as JLoader
from repro.data.packing import build_minibatch as jbuild
from repro.kernels import ops
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as jinit
from repro_torch import bridge
from repro_torch.configs import get_reduced
from repro_torch.core import backend as B
from repro_torch.core import fsdp
from repro_torch.core.ranks import RankGroup
from repro_torch.core.train_step import Trainer
from repro_torch.data.loader import SyntheticSFTLoader
from repro_torch.data.packing import build_minibatch
from repro_torch.kernels import odc_gather as G
from repro_torch.kernels import odc_scatter as S
from repro_torch.launch import train as train_cli
from repro_torch.optim.adamw import AdamWConfig

ARCH = "qwen-1.5b"
LOSS_RTOL = 1e-5
LR = 1e-3
STEPS = 3
MAX_TOKENS = 128
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite runs several workers on the
    CPU's cores, and these small tensors gain nothing from more."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(fn, x, n):
    """fn inside shard_map over n devices on the stack of the ranks'
    inputs (n, ...); returns the ranks' outputs stacked (n, ...)."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    f = jax.jit(jax.shard_map(lambda xd: fn(xd[0])[None], mesh=mesh,
                              in_specs=P("data"), out_specs=P("data"),
                              check_vma=False))
    return np.asarray(f(x).astype(jnp.float32))


def _ranks(x, tdtype):
    return [torch.from_numpy(np.array(a)).to(tdtype) for a in x]


def _assert_bitwise(ours, ref):
    ours = np.stack([t.float().numpy() for t in ours])
    assert ours.shape == ref.shape
    assert np.array_equal(ours.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_chained_gather_matches_the_pallas_kernel(n, dtype):
    jd, td = DTYPES[dtype]
    x = np.random.default_rng(n).normal(size=(n, 3, 5, 4)).astype(np.float32)
    ref = _run(lambda s: ops.odc_gather_layers(s, "data", interpret=True),
               jnp.asarray(x).astype(jd), n)
    _assert_bitwise(G.odc_gather_layers_plain(_ranks(x, td)), ref)
    _assert_bitwise(G.odc_gather_layers(_ranks(x, td)), ref)
    out = [torch.full((3, 5 * n, 4), 7.0, dtype=td) for _ in range(n)]
    _assert_bitwise(G.odc_gather_layers(_ranks(x, td), out=out), ref)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_chained_scatter_matches_the_pallas_kernel(n, dtype):
    """Natural and backward layer order give the Pallas kernel's sums;
    with ``out`` they are added to it (in the output type)."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(10 + n)
    y = rng.normal(size=(n, 3, 2 * n, 4)).astype(np.float32)
    ref = _run(lambda s: ops.odc_scatter_accumulate_layers(
        s, "data", interpret=True), jnp.asarray(y).astype(jd), n)
    for reverse in (False, True):
        _assert_bitwise(S.odc_scatter_accumulate_layers_plain(
            _ranks(y, td), reverse=reverse), ref)
        _assert_bitwise(S.odc_scatter_accumulate_layers(
            _ranks(y, td), reverse=reverse), ref)
    start = rng.normal(size=(n, 3, 2, 4)).astype(np.float32)
    acc = _ranks(start, td)
    S.odc_scatter_accumulate_layers(_ranks(y, td), reverse=True, out=acc)
    want = [a + torch.from_numpy(np.array(r)).to(td)
            for a, r in zip(_ranks(start, td), ref)]
    _assert_bitwise(acc, np.stack([w.float().numpy() for w in want]))


def test_chained_rings_take_a_ring_order():
    """A profile-ordered ring gives every layer what the single-layer
    plain ring gives it."""
    order = [0, 2, 3, 1]
    x = torch.randn(4, 3, 4, 2, generator=torch.Generator().manual_seed(0))
    out = G.odc_gather_layers(list(x), order)
    for l in range(3):
        ref = G.odc_gather_plain([s[l] for s in x], order)
        assert all(torch.equal(o[l], r) for o, r in zip(out, ref))
    y = torch.randn(4, 3, 8, 2, generator=torch.Generator().manual_seed(1))
    out = S.odc_scatter_accumulate_layers(list(y), order, reverse=True)
    for l in range(3):
        ref = S.odc_scatter_accumulate_plain([s[l] for s in y], order)
        assert all(torch.equal(o[l], r) for o, r in zip(out, ref))


def test_resolve_applies_the_implied_schedule():
    for name in ("odc-overlap", "overlap"):
        for schedule in ("minibatch", "layer", "overlap"):
            backend, sched = B.resolve(name, schedule)
            assert backend is B.ODC_OVERLAP and sched == "overlap"
            assert backend.name == "odc-overlap"
    assert B.resolve("odc", "overlap") == (B.ODC, "overlap")
    assert B.resolve("collective", "overlap") == (B.COLLECTIVE, "overlap")
    assert B.resolve("odc", "minibatch") == (B.ODC, "minibatch")
    assert "odc-overlap" in B.backend_names()
    assert B.resolve("odc", "1f1b") == (B.ODC, "1f1b")
    for name in ("pipe", "pipe-int8"):
        for schedule in ("minibatch", "layer", "overlap", "1f1b"):
            assert B.resolve(name, schedule)[1] == "1f1b"


def test_layer_packing_round_trips():
    """Packing, unpacking and the cotangent write of one layer: the
    pieces land where the gather puts them, and the full leaves are the
    ranks' shards concatenated along each leaf's sharded dim."""
    from repro_torch.core import overlap
    from repro_torch.models import transformer as T

    cfg = get_reduced(ARCH)
    n = 2
    shapes = T.param_shapes(cfg)
    dims = fsdp.leaf_dims(shapes, n)
    packing = overlap.LayerPacking(shapes, dims, n)
    assert len(packing.entries) == 9 and not packing.replicated
    params = T.init_params(cfg, torch.Generator().manual_seed(3))
    shards = fsdp.shard_params(params, RankGroup.make(n, "cpu"))
    rows = []
    for s in shards:
        row = torch.empty(cfg.num_layers, packing.c_flat)
        packing.pack(s["layers"], row)
        rows.append(row)
    full = G.odc_gather_layers(rows)
    for l in range(cfg.num_layers):
        leaves = packing.unpack(full[0][l])
        for (path, *_), leaf in zip(packing.entries, leaves):
            assert torch.equal(leaf, fsdp.get(params["layers"], path)[l])
        buf = torch.zeros_like(full[0][l])
        packing.write(buf, leaves)
        assert torch.equal(buf, full[0][l])
    views = packing.grad_views(rows[1])
    for path, *_ in packing.entries:
        assert torch.equal(fsdp.get(views, path),
                           fsdp.get(shards[1]["layers"], path))


@pytest.fixture(scope="module")
def jax_model():
    cfg = jconfigs.get_reduced(ARCH)
    return cfg, JT.init_params(cfg, jax.random.PRNGKey(0))


def _loader(cls, world):
    return cls("longalign", vocab_size=512, world_size=world,
               minibatch_per_device=2, max_tokens=MAX_TOKENS, max_len=120,
               seed=0)


def _steps(world):
    out = []
    for a, b in zip(_loader(JLoader, world).steps(STEPS),
                    _loader(SyntheticSFTLoader, world).steps(STEPS)):
        out.append((jbuild(a["plan"], a["sample_tokens"], MAX_TOKENS),
                    build_minibatch(b["plan"], b["sample_tokens"],
                                    MAX_TOKENS),
                    [len(d) for d in b["plan"].assignments]))
    return out


def _trainer(world, comm, schedule):
    return Trainer(get_reduced(ARCH), RankGroup.make(world, "cpu"),
                   comm=comm, schedule=schedule, opt_cfg=AdamWConfig(lr=LR))


def _state(jax_model, trainer):
    _, params = jax_model
    return bridge.train_state_from_numpy(
        jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, jinit(params)), trainer)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("comm", ["odc", "collective"])
def test_three_steps_match_the_jax_overlap_engine(jax_model, world, comm):
    cfg, params = jax_model
    mesh = make_host_mesh(data=world, model=1)
    step = jax.jit(make_train_step(
        cfg, mesh, GSPMDConfig(comm=comm, schedule="overlap",
                               block_kv=MAX_TOKENS), JAdamW(lr=LR)))
    tr = _trainer(world, "odc-overlap" if comm == "odc" else comm,
                  "overlap")
    assert tr.schedule == "overlap" and (tr.chain is None) == (
        comm == "collective")
    shards, opt = _state(jax_model, tr)
    jp, jo = params, jinit(params)
    for jb, tb, counts in _steps(world):
        with mesh:
            jp, jo, jm = step(jp, jo, jb)
        shards, opt, tm = tr.step(shards, opt, tb, counts)
        ref = float(jm["loss"])
        assert abs(float(tm["loss"]) - ref) <= LOSS_RTOL * abs(ref)
        assert float(tm["tokens"]) == float(jm["tokens"])
    ours = tr.unshard(shards)
    for path, p in jax.tree_util.tree_leaves_with_path(jp):
        keys = tuple(k.key for k in path)
        err = np.abs(fsdp.get(ours, keys).numpy() - np.asarray(p)).max()
        assert err <= 2 * LR * STEPS, (keys, float(err))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("comm", ["odc", "collective"])
def test_overlap_computes_the_layer_schedule_step(jax_model, world, comm):
    """The same step-0 loss and gradients as the layer schedule on the
    same backend, bit for bit; and the same step-0 loss as collective x
    layer (the same forward)."""
    _, tb, counts = _steps(world)[0]
    out = {}
    for c, schedule in ((comm, "layer"), (comm, "overlap"),
                        ("collective", "layer")):
        tr = _trainer(world, c, schedule)
        shards, _ = _state(jax_model, tr)
        grads, m = tr.grads(shards, tb, counts)
        out[c, schedule] = (float(m["loss"]), tr.unshard(grads))
    (la, ga), (lb, gb) = out[comm, "layer"], out[comm, "overlap"]
    assert la == lb == out["collective", "layer"][0]
    for path in fsdp.tree_paths(ga):
        assert torch.equal(fsdp.get(ga, path), fsdp.get(gb, path)), path


def test_driver_cli_with_odc_overlap(capsys):
    assert train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--data-axis", "2", "--steps", "2",
                           "--comm", "odc-overlap"]) == 0
    out = capsys.readouterr().out
    assert "schedule=overlap comm=odc-overlap" in out
    assert "step    1 loss=" in out and "kernel launches" in out
    summary = train_cli.run(train_cli.parse_args(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--data-axis", "2",
         "--steps", "2", "--schedule", "overlap"]))
    assert summary["comm"] == "odc" and summary["schedule"] == "overlap"
    assert all(np.isfinite(summary["losses"]))
    # CPU tensors take the plain versions: no kernel launched
    assert set(summary["launches"]) >= {"odc_gather_layers",
                                        "odc_scatter_accumulate_layers"}
    assert set(summary["launches"].values()) == {0}
