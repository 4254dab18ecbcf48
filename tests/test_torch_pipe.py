"""The port's two-tier backends (``hier``, ``pipe``, ``pipe-int8``) and the
1F1B schedule against the JAX package, on the CPU.

* The chunked int8 codec: ``odc.quantize_chunked`` / ``dequantize_chunked``
  and ``kernels.quant``'s wrappers (their plain versions on CPU tensors)
  against the JAX ``quantize_chunked`` / ``dequantize_chunked`` and the
  Pallas ``quantize_pallas`` / ``dequantize_pallas`` in interpret mode:
  bitwise, on all-zero chunks, exact .5 ties, a ragged tail and chunk
  extremes that land on +-127.  Both sides divide in IEEE f32 and round
  half to even.
* The q8 rings: ``ring_gather_q8`` / ``ring_scatter_accumulate_q8``
  against the JAX rings under ``shard_map`` (n = 2, 3, 4, natural and
  profile order), and against the Pallas q8 kernels in interpret mode
  (natural order): bitwise.  The gather moves codes, and the scatter
  requantizes and adds in the same hop order, its dequantize-and-add one
  fused multiply-add as XLA compiles it (``odc.fma``, held to an exact
  rounding of the exact sum, ties included).
* The hier transport: a two-tier gather and scatter on a 2 x 2 layout,
  with and without a per-device profile, bitwise against the JAX
  backends' ``param_gather`` (forward and VJP) for hier, pipe and
  pipe-int8; a leaf sharded over the intra tier alone uses its
  collective only.
* The 1-D leaf layout under a 2 x 2 world against ``gspmd.param_pspecs``.
* ``sim.timeline``'s copies equal the originals.
* The 1F1B loop: gradients equal the minibatch schedule's (bitwise: the
  same forwards, and autograd accumulates the same backwards in the same
  order); no microbatches give zero gradients.
* Step-0 gradients on a 2 x 2 layout for hier x {minibatch, layer}, pipe
  and pipe-int8, leaf by leaf: against ``jax.grad``, and for pipe-int8
  against the JAX pipe-int8 engine's gradient (bounds in the test); and
  the reported gradient norm against the unsharded gradient's.
* Three train steps against ``gspmd.make_train_step`` for hier x
  {minibatch, layer} on ``make_hier_mesh(nodes=2, device=2)`` and pipe,
  pipe interleaved and pipe-int8 on ``make_pipe_mesh(stages=2, data=2)``:
  losses within 1e-5 relative, tokens equal.  The reason of
  ``tests/test_torch_train_engine.py`` holds for the f32 runs.  For
  pipe-int8 the port's q8 rings are bitwise the reference's on identical
  inputs; the engines' parameters after step 0 differ by f32 rounding,
  which can move a quantized value by one step (a relative change of at
  most 1/127 of that chunk's absmax in one weight), which moves the loss
  by far less than 1e-5 of itself: the same bound holds.
* The train driver on ``--device cpu --reduced`` for the three backends,
  and its refusals: hier under the overlap schedule, and a world that the
  two tiers cannot split.
"""
import inspect
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro import configs as jconfigs
from repro.balance.cost import make_straggler_profile as jprofile
from repro.core import backend as JB
from repro.core import odc as jodc
from repro.core.gspmd import (GSPMDConfig, ShardingRules, make_train_step,
                              param_pspecs)
from repro.data.loader import SyntheticSFTLoader as JLoader
from repro.data.packing import build_minibatch as jbuild
from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro.launch.mesh import make_hier_mesh, make_pipe_mesh
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as jinit
from repro.sim import timeline as jtimeline
from repro_torch import bridge
from repro_torch.balance.cost import make_straggler_profile
from repro_torch.configs import get_reduced
from repro_torch.core import backend as B
from repro_torch.core import fsdp, odc
from repro_torch.core.ranks import RankGroup, Tiers
from repro_torch.core.train_step import Trainer
from repro_torch.data.loader import SyntheticSFTLoader
from repro_torch.data.packing import build_minibatch
from repro_torch.kernels import quant
from repro_torch.launch import train as train_cli
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sim import timeline
from torch_train_cases import GRAD_TOL, global_mean_grad

ARCH = "qwen-1.5b"
LOSS_RTOL = 1e-5
LR = 1e-3
MAX_TOKENS = 128


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: the suite runs several workers on the
    CPU's cores, and these small tensors gain nothing from more."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _shard_run(fn, mesh, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


# ===========================================================================
# the chunked int8 codec
# ===========================================================================
def _codec_input(size, seed):
    """Mixed-scale values with an all-zero chunk, a chunk of exact ties
    (absmax 127, so scale 1 and every x.5 is a tie), a chunk whose
    extremes land on +-127, and a ragged tail when size is not a multiple
    of 256."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=size)
         * 10.0 ** rng.integers(-3, 4, size=size)).astype(np.float32)
    x[:256] = 0.0
    x[256:512] = (np.arange(256) % 9 - 4 + 0.5).astype(np.float32)
    x[256] = 127.0
    x[512:768] = np.linspace(-3.0, 3.0, 256, dtype=np.float32)
    return x


@pytest.mark.parametrize("size", [3 * 256, 1000, 4096 + 17])
def test_codec_is_bitwise_the_reference(size):
    """Against ``quantize_chunked`` and ``dequantize_chunked`` as the
    engine runs them (jitted) and the Pallas codec in interpret mode."""
    x = _codec_input(size, size)
    qj, sj = jax.jit(jodc.quantize_chunked)(jnp.asarray(x))
    qp, sp = jquant.quantize_pallas(jops._chunk_blocks(jnp.asarray(x), 256),
                                    interpret=True)
    for q, s in (odc.quantize_chunked(torch.from_numpy(x)),
                 quant.quantize_int8(torch.from_numpy(x))):
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        for qr, sr in ((qj, sj), (qp, sp)):
            np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
            np.testing.assert_array_equal(s.numpy(), np.asarray(sr))
    q = q.numpy()
    assert (q[0] == 0).all() and (sj[0] == 1.0)  # zeros round-trip
    np.testing.assert_array_equal(  # ties to even: 0.5 -> 0, 1.5 -> 2
        q[1, 1:9], np.rint(x[257:265]).astype(np.int8))
    assert q[2].min() == -127 and q[2].max() == 127 and q.min() >= -127
    shape = (size,)
    dj = np.asarray(jax.jit(jodc.dequantize_chunked, static_argnums=2)(
        qj, sj, shape))
    dp = np.asarray(jquant.dequantize_pallas(qp, sp, interpret=True)
                    ).reshape(-1)[:size]
    tq, ts = torch.from_numpy(q), torch.from_numpy(np.array(sj))
    for d in (odc.dequantize_chunked(tq, ts, shape),
              quant.dequantize_int8(tq, ts, shape)):
        np.testing.assert_array_equal(d.numpy(), dj)
        np.testing.assert_array_equal(d.numpy(), dp)


def test_codec_against_the_eager_oracle():
    """The reference writes the scale as ``absmax / 127.0``; jitted, XLA
    computes ``absmax * fl(1/127)`` (what the port computes), while an
    eager call divides.  The two differ by one unit in the last place on
    some chunks (ROADMAP.md, caveats on the reference); the codes agree
    here, and the port is the compiled form on every chunk."""
    x = _codec_input(256 * 400, 7)
    qe, se = (np.asarray(a) for a in jodc.quantize_chunked(jnp.asarray(x)))
    q, s = (a.numpy() for a in odc.quantize_chunked(torch.from_numpy(x)))
    absmax = np.abs(x.reshape(-1, 256)).max(axis=1, keepdims=True)
    live = absmax > 0
    np.testing.assert_array_equal(se[live], absmax[live] / np.float32(127))
    np.testing.assert_array_equal(
        s[live], absmax[live] * (np.float32(1) / np.float32(127)))
    differ = se != s
    assert differ.any()
    np.testing.assert_array_equal(
        np.abs(se.view(np.int32) - s.view(np.int32))[differ], 1)
    np.testing.assert_array_equal(q, qe)


# ===========================================================================
# the q8 rings
# ===========================================================================
def _data_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("data",))


def _orders(n):
    """(JAX profile, port ring order) pairs: natural, and a profile's."""
    prof = make_straggler_profile("uniform", n, slow_factor=2.0, seed=0)
    order = odc.ring_order(n, prof)
    assert order is not None
    return [(None, None), (jprofile("uniform", n, slow_factor=2.0, seed=0),
                           order)]


def _round_f32(x):
    """The f32 nearest the exact rational x, ties to even."""
    from fractions import Fraction

    f = np.float32(float(x))
    best = None
    for g in (np.nextafter(f, np.float32(-np.inf)), f,
              np.nextafter(f, np.float32(np.inf))):
        d = abs(Fraction(float(g)) - x)
        if best is None or d < best[0] or (
                d == best[0] and int(g.view(np.int32)) % 2 == 0):
            best = (d, g)
    return best[1]


def test_fma_rounds_once():
    """``odc.fma`` against an exact rounding of the exact a*b + c: random
    code x scale + value triples, and sums that f64 rounds onto the
    midpoint of two f32 values (1 + 2^-24 + 2^-54 must round up, its
    mirror down), where a product and an add, or a naive f64 sum, round
    to the even neighbour instead."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a = rng.integers(-127, 128, size=400).astype(np.float32)
    b = (rng.normal(size=400) * 10.0 ** rng.integers(-6, 3, size=400)
         ).astype(np.float32)
    c = (rng.normal(size=400) * 10.0 ** rng.integers(-6, 3, size=400)
         ).astype(np.float32)
    b[:2] = np.float32(16519105 * 2.0 ** -54)  # 65 * b = 2^-24 + 2^-54
    a[:2], c[0], c[1] = 65.0, 1.0, -1.0
    a[1] = -65.0
    got = odc.fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.nextafter(np.float32(1), np.float32(2))
    assert got[1] == -np.nextafter(np.float32(1), np.float32(2))
    assert np.float32(a[0] * b[0] + c[0]) == np.float32(1)  # two roundings


@pytest.mark.parametrize("n", [2, 3, 4])
def test_q8_rings_are_bitwise_the_reference(n):
    rng = np.random.default_rng(n)
    c = 37  # 37 * 5 values: a ragged tail
    xs = (rng.normal(size=(n, c, 5)) * 3).astype(np.float32)
    ys = (rng.normal(size=(n, n * c, 5)) * 3).astype(np.float32)
    mesh = _data_mesh(n)
    for jprof, order in _orders(n):
        g = _shard_run(lambda x: jodc.ring_gather_q8(
            x[0], "data", device_profile=jprof)[None], mesh, P("data"),
            P("data"))(jnp.asarray(xs))
        s = _shard_run(lambda y: jodc.ring_scatter_accumulate_q8(
            y[0], "data", device_profile=jprof)[None], mesh, P("data"),
            P("data"))(jnp.asarray(ys))
        gath = odc.ring_gather_q8([torch.from_numpy(x) for x in xs], order)
        scat = odc.ring_scatter_accumulate_q8(
            [torch.from_numpy(y) for y in ys], order)
        for r in range(n):
            np.testing.assert_array_equal(gath[r].numpy(), np.asarray(g[r]))
            np.testing.assert_array_equal(scat[r].numpy(), np.asarray(s[r]))
            # the own shard lands exactly
            np.testing.assert_array_equal(
                gath[r][r * c:(r + 1) * c].numpy(), xs[r])


@pytest.mark.parametrize("n", [2, 4])
def test_q8_wrappers_are_bitwise_the_pallas_kernels(n):
    rng = np.random.default_rng(10 + n)
    xs = rng.normal(size=(n, 16, 7)).astype(np.float32)
    ys = rng.normal(size=(n, n * 9, 6)).astype(np.float32)
    mesh = _data_mesh(n)
    g = _shard_run(lambda x: jops.odc_gather_q8(x[0], "data",
                                                interpret=True)[None],
                   mesh, P("data"), P("data"))(jnp.asarray(xs))
    s = _shard_run(lambda y: jops.odc_scatter_accumulate_q8(
        y[0], "data", interpret=True)[None], mesh, P("data"),
        P("data"))(jnp.asarray(ys))
    gath = quant.odc_gather_q8([torch.from_numpy(x) for x in xs])
    scat = quant.odc_scatter_accumulate_q8([torch.from_numpy(y) for y in ys])
    for r in range(n):
        np.testing.assert_array_equal(gath[r].numpy(), np.asarray(g[r]))
        np.testing.assert_array_equal(scat[r].numpy(), np.asarray(s[r]))
    # the ring itself: every rank's codes and scales, row s rank s's
    enc = [quant.quantize_int8(torch.from_numpy(x)) for x in xs]
    qj, sj = _shard_run(lambda q, sc: tuple(a[None] for a in (
        jquant.odc_gather_q8_pallas(q[0], sc[0], axis_name="data",
                                    interpret=True))), mesh,
        (P("data"), P("data")), (P("data"), P("data")))(
        jnp.asarray(np.stack([q.numpy() for q, _ in enc])),
        jnp.asarray(np.stack([sc.numpy() for _, sc in enc])))
    qs, ss = quant.gather_codes([q for q, _ in enc], [sc for _, sc in enc])
    for r in range(n):
        np.testing.assert_array_equal(qs[r].numpy(), np.asarray(qj[r]))
        np.testing.assert_array_equal(ss[r].numpy(), np.asarray(sj[r]))
    assert quant.gather_launches == quant.scatter_launches == 0


# ===========================================================================
# the two-tier transport
# ===========================================================================
@pytest.mark.parametrize("name", ["hier", "pipe", "pipe-int8"])
@pytest.mark.parametrize("profiled", [False, True])
def test_two_tier_transport_is_bitwise_the_reference(name, profiled):
    """Gather and scatter over (2 nodes x 2 devices), forward and VJP of
    the JAX backend's ``param_gather``, against the port's backend on the
    same shards and cotangents."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4 * 3, 10)) * 2).astype(np.float32)
    ct = (rng.normal(size=(4, 4 * 3, 10)) * 2).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("node", "device"))
    axes = ("node", "device")
    jprof = jprofile("one_slow", 4, slow_factor=3.0) if profiled else None
    prof = (make_straggler_profile("one_slow", 4, slow_factor=3.0)
            if profiled else None)
    jb = JB.get_backend(name)

    def f(xs, cts):
        full, vjp = jax.vjp(jb.param_gather(axes, device_profile=jprof), xs)
        (g,) = vjp(cts[0])
        return full[None], g

    full, grad = _shard_run(f, mesh, (P(axes), P(axes)),
                            (P(axes), P(axes)))(jnp.asarray(x),
                                                jnp.asarray(ct))
    tb = B.get_backend(name).on(Tiers(2, 2))
    order = tb.ring_order(4, prof)
    if profiled:
        assert order == odc.ring_order(2, prof.node_collapse(2))
    shards = [torch.from_numpy(x[3 * r:3 * (r + 1)]) for r in range(4)]
    got = tb.param_gather(shards, 0, order)
    for r in range(4):
        np.testing.assert_array_equal(got[r].detach().numpy(),
                                      np.asarray(full[r]))
    sums = tb.scatter_accumulate([torch.from_numpy(c) for c in ct], order)
    np.testing.assert_array_equal(torch.cat(sums).numpy(), np.asarray(grad))


def test_intra_only_leaf_uses_the_intra_collective():
    """A leaf sharded over the trailing (intra) axis alone: JAX's
    single-tier path, against the port's ``IntraDim`` gather and
    scatter."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6)).astype(np.float32)
    ct = rng.normal(size=(4, 2, 6)).astype(np.float32)
    axes = ("node", "device")
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), axes)

    def f(xs, cts):
        full, vjp = jax.vjp(JB.HIER.param_gather("device", dim=1), xs)
        (g,) = vjp(cts[0])
        return full[None], g[None]

    full, grad = _shard_run(f, mesh, (P(None, "device"), P(axes)),
                            (P(axes), P(axes)))(jnp.asarray(x),
                                                jnp.asarray(ct))
    tb = B.HIER.on(Tiers(2, 2))
    d = fsdp.IntraDim(1, 2)
    shards = [torch.from_numpy(x[:, 3 * (r % 2):3 * (r % 2 + 1)])
              for r in range(4)]
    got = tb.gather_dim(shards, d)
    sums = tb.scatter_dim([torch.from_numpy(c) for c in ct], d)
    for r in range(4):
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(full[r]))
        np.testing.assert_array_equal(sums[r].numpy(), np.asarray(grad[r]))


def test_tiers_lay_ranks_out_node_major():
    t = Tiers.split(6, 2)
    assert (t.inter, t.intra, t.n) == (2, 3, 6)
    assert t.intra_groups() == [range(0, 3), range(3, 6)]
    assert t.inter_rings() == [[0, 3], [1, 4], [2, 5]]
    mesh = make_hier_mesh(nodes=2, device=3)
    ids = [d.id for d in np.asarray(mesh.devices).reshape(-1)]
    assert [ids.index(jax.devices()[r].id) for r in range(6)] == list(
        range(6))  # rank t*intra + d is mesh position (t, d)
    with pytest.raises(ValueError, match="do not split"):
        Tiers.split(6, 4)


def test_one_dim_leaves_follow_leaf_pspec_under_two_tiers():
    cfg = jconfigs.get_reduced(ARCH)
    shapes = jax.eval_shape(lambda k: JT.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    for mesh, rules in ((make_hier_mesh(nodes=2, device=2),
                         ShardingRules(data=("node", "device"))),
                        (make_pipe_mesh(stages=2, data=2),
                         ShardingRules(data=("pipe", "data")))):
        specs = param_pspecs(cfg, shapes, rules, mesh)
        inter, intra = rules.data
        dims = fsdp.leaf_dims(
            jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                         shapes), 4, intra=2)
        for path, spec in jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda s: isinstance(s, P)):
            keys = tuple(k.key for k in path)
            d = fsdp.get(dims, keys)
            data = [i for i, e in enumerate(spec) if e in (rules.data, intra)]
            if not data:
                assert d is None, keys
            elif spec[data[0]] == intra:
                assert isinstance(d, fsdp.IntraDim), keys
                assert (int(d), d.intra) == (data[0], 2), keys
            else:
                assert type(d) is int and d == data[0], keys
        assert any(isinstance(fsdp.get(dims, p), fsdp.IntraDim)
                   for p in fsdp.tree_paths(dims))


# ===========================================================================
# the 1F1B order and loop
# ===========================================================================
def test_timeline_copies_equal_the_originals():
    for fn in ("stage_partition", "instructions_1f1b"):
        assert inspect.getsource(getattr(timeline, fn)) == \
            inspect.getsource(getattr(jtimeline, fn))
    for M in (0, 1, 3, 7):
        for S in (1, 2, 3, 8):
            assert timeline.stage_partition(M, S) == \
                jtimeline.stage_partition(M, S)
            for stage in range(S):
                for il in (False, True):
                    assert timeline.instructions_1f1b(
                        M, S, stage=stage, interleave=il) == \
                        jtimeline.instructions_1f1b(M, S, stage=stage,
                                                    interleave=il)


def _loader(cls, world, n=2):
    return cls("longalign", vocab_size=512, world_size=world,
               minibatch_per_device=n, max_tokens=MAX_TOKENS, max_len=120,
               seed=0)


def _steps(world, n, minibatch_per_device=2):
    out = []
    for a, b in zip(_loader(JLoader, world, minibatch_per_device).steps(n),
                    _loader(SyntheticSFTLoader, world,
                            minibatch_per_device).steps(n)):
        out.append((jbuild(a["plan"], a["sample_tokens"], MAX_TOKENS),
                    build_minibatch(b["plan"], b["sample_tokens"],
                                    MAX_TOKENS),
                    [len(d) for d in b["plan"].assignments]))
    return out


@pytest.fixture(scope="module")
def jax_model():
    cfg = jconfigs.get_reduced(ARCH)
    return cfg, JT.init_params(cfg, jax.random.PRNGKey(0))


def _state(jax_model, tr):
    _, params = jax_model
    return bridge.train_state_from_numpy(
        jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, jinit(params)), tr)


@pytest.mark.parametrize("inter,interleave", [(2, False), (2, True),
                                              (4, False)])
def test_1f1b_gradients_equal_the_minibatch_schedule(jax_model, inter,
                                                     interleave):
    """Step 0 of pipe (1F1B over ``inter`` stages) against hier under the
    minibatch schedule on the same layout: the same loss and gradients,
    bitwise; and with no microbatches, zero gradients."""
    _, tb, counts = _steps(4, 1, minibatch_per_device=8)[0]
    assert max(counts) >= 3  # warmup, steady state and drain
    out = {}
    for comm, schedule in (("hier", "minibatch"), ("pipe", "1f1b")):
        tr = Trainer(get_reduced(ARCH), RankGroup.make(4, "cpu"),
                     comm=comm, schedule=schedule, inter=inter,
                     pipe_interleave=interleave)
        shards, _ = _state(jax_model, tr)
        grads, m = tr.grads(shards, tb, counts)
        out[comm] = (float(m["loss"]), tr.unshard(grads))
    assert out["pipe"][0] == out["hier"][0]
    for path in fsdp.tree_paths(out["hier"][1]):
        assert torch.equal(fsdp.get(out["pipe"][1], path),
                           fsdp.get(out["hier"][1], path)), path
    grads, m = tr.grads(shards, tb, [0] * 4)
    assert float(m["tokens"]) == 0.0 and float(m["loss"]) == 0.0
    for g in grads:
        for path in fsdp.tree_paths(g):
            assert not fsdp.get(g, path).any(), path


# ===========================================================================
# step-0 gradients of the two-tier layouts
# ===========================================================================
GRAD_CASES = [("hier", "minibatch"), ("hier", "layer"), ("pipe", "1f1b"),
              ("pipe-int8", "1f1b")]


@pytest.fixture(scope="module")
def tier_step0(jax_model):
    """The world-4 step-0 batch; ``jax.grad`` of the global mean loss; and
    the JAX pipe-int8 engine's own step-0 gradient on
    ``make_pipe_mesh(stages=2, data=2)``, read back from its first AdamW
    moment (no clipping: m = (1 - b1) g)."""
    cfg, params = jax_model
    jb, tb, counts = _steps(4, 1)[0]
    loss, tok, ref = global_mean_grad(cfg, params, jb, 4)
    mesh = make_pipe_mesh(stages=2, data=2)
    opt = JAdamW(lr=LR, grad_clip=0.0)
    step = jax.jit(make_train_step(cfg, mesh, GSPMDConfig(
        rules=ShardingRules(data=("pipe", "data")), comm="pipe-int8",
        schedule="1f1b", block_kv=MAX_TOKENS), opt))
    with mesh:
        _, jo, _ = step(params, jinit(params), jb)
    q8 = jax.tree.map(lambda m: np.asarray(m) / np.float32(1 - opt.b1),
                      jo["m"])
    return tb, counts, loss, tok, ref, q8


def _tier_trainer(comm, schedule):
    return Trainer(get_reduced(ARCH), RankGroup.make(4, "cpu"), comm=comm,
                   schedule=schedule, opt_cfg=AdamWConfig(lr=LR), inter=2)


@pytest.mark.parametrize("comm,schedule", GRAD_CASES)
def test_two_tier_step0_gradients_match_jax_grad(jax_model, tier_step0,
                                                 comm, schedule):
    """Step 0 on a 2 x 2 layout, leaf by leaf, the intra-only norm leaves
    (summed over the inter tier) and the pieces ``unshard`` takes from
    the first intra group included.  hier and pipe against ``jax.grad``
    within ``GRAD_TOL`` of the leaf's max, the bound and reason of
    ``tests/test_torch_train_grads.py``.  pipe-int8 quantizes its
    parameters, so its reference is the JAX pipe-int8 engine's gradient:
    the norm leaves stay off the int8 wire and hold GRAD_TOL; a leaf on
    the wire may also have a few elements one code step apart (the q8
    scatter requantizes each rank's partial sum, and the engines'
    partials differ by f32 rounding, which can move a value across a
    rounding boundary): each element within GRAD_TOL + 1/127 of the
    leaf's max, at most 1e-3 of the elements beyond GRAD_TOL, and the
    whole leaf within 1e-3 relative in norm.  A missing rank, tier or
    normalization is off by O(1) in most elements."""
    tb, counts, loss, tok, ref, q8 = tier_step0
    tr = _tier_trainer(comm, schedule)
    shards, _ = _state(jax_model, tr)
    grads, m = tr.grads(shards, tb, counts)
    assert float(m["tokens"]) == tok
    full = tr.unshard(grads)
    for path, g in jax.tree_util.tree_leaves_with_path(
            q8 if comm == "pipe-int8" else ref):
        keys = tuple(k.key for k in path)
        g = np.asarray(g)
        ours = fsdp.get(full, keys).numpy()
        assert ours.shape == g.shape
        err = np.abs(ours - g)
        scale = np.abs(g).max()
        if comm != "pipe-int8":
            assert abs(float(m["loss"]) - loss) <= 1e-6 * abs(loss)
            assert err.max() <= GRAD_TOL * scale, (keys, float(err.max()))
        elif keys[-1].endswith("norm"):
            assert err.max() <= GRAD_TOL * scale, (keys, float(err.max()))
        else:
            assert err.max() <= (GRAD_TOL + 1 / 127) * scale, keys
            assert (err > GRAD_TOL * scale).mean() <= 1e-3, keys
            assert np.linalg.norm(ours - g) <= 1e-3 * np.linalg.norm(g), \
                keys


@pytest.mark.parametrize("comm,schedule", GRAD_CASES)
def test_two_tier_step_reports_the_gradient_norm_before_clipping(
        jax_model, tier_step0, comm, schedule):
    """``metrics["grad_norm"]`` on a 2 x 2 layout: the global norm of the
    whole step-0 gradient with each piece counted once (an intra-only
    leaf lives on every intra group), against the float64 norm of the
    unsharded gradient, 1e-5 relative as in
    ``tests/test_torch_train_grads.py``."""
    tb, counts = tier_step0[:2]
    tr = _tier_trainer(comm, schedule)
    shards, opt = _state(jax_model, tr)
    grads, _ = tr.grads(shards, tb, counts)
    full = tr.unshard(grads)
    ref = sum(float(fsdp.get(full, p).double().square().sum())
              for p in fsdp.tree_paths(full)) ** 0.5
    _, _, m = tr.step(shards, opt, tb, counts)
    assert abs(float(m["grad_norm"]) - ref) <= 1e-5 * ref


# ===========================================================================
# three steps against the JAX engine
# ===========================================================================
ENGINE_CASES = [("hier", "minibatch", False), ("hier", "layer", False),
                ("pipe", "1f1b", False), ("pipe", "1f1b", True),
                ("pipe-int8", "1f1b", False)]


@pytest.mark.parametrize("comm,schedule,interleave", ENGINE_CASES)
def test_three_step_losses_match_the_jax_engine(jax_model, comm, schedule,
                                                interleave):
    cfg, params = jax_model
    if comm == "hier":
        mesh = make_hier_mesh(nodes=2, device=2)
        rules = ShardingRules(data=("node", "device"))
    else:
        mesh = make_pipe_mesh(stages=2, data=2)
        rules = ShardingRules(data=("pipe", "data"))
    step = jax.jit(make_train_step(cfg, mesh, GSPMDConfig(
        rules=rules, comm=comm, schedule=schedule, block_kv=MAX_TOKENS,
        pipe_interleave=interleave), JAdamW(lr=LR)))
    tr = Trainer(get_reduced(ARCH), RankGroup.make(4, "cpu"), comm=comm,
                 schedule=schedule, opt_cfg=AdamWConfig(lr=LR), inter=2,
                 pipe_interleave=interleave)
    assert tr.schedule == schedule
    shards, opt = _state(jax_model, tr)
    jp, jo = params, jinit(params)
    for jb, tb, counts in _steps(4, 3):
        with mesh:
            jp, jo, jm = step(jp, jo, jb)
        shards, opt, tm = tr.step(shards, opt, tb, counts)
        ref = float(jm["loss"])
        assert abs(float(tm["loss"]) - ref) <= LOSS_RTOL * abs(ref), \
            (float(tm["loss"]), ref)
        assert float(tm["tokens"]) == float(jm["tokens"])


# ===========================================================================
# the driver
# ===========================================================================
@pytest.mark.parametrize("flags", [
    ["--comm", "hier", "--nodes", "2"],
    ["--comm", "pipe", "--pipe-stages", "2", "--pipe-interleave"],
    ["--comm", "pipe-int8", "--pipe-stages", "4"]])
def test_driver_runs_the_two_tier_backends(flags):
    summary = train_cli.run(train_cli.parse_args(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--data-axis", "4",
         "--steps", "2", "--quiet", *flags]))
    assert len(summary["losses"]) == 2
    assert all(np.isfinite(summary["losses"]))
    inter = int(flags[3])
    assert summary["tiers"] == (inter, 4 // inter)
    assert summary["schedule"] == ("minibatch" if "hier" in flags
                                   else "1f1b")
    assert set(summary["launches"].values()) == {0}  # CPU: plain versions


@pytest.mark.parametrize("flags,err", [
    (["--comm", "hier", "--schedule", "overlap"], "not yet ported"),
    (["--comm", "pipe-int8", "--data-axis", "2", "--pipe-stages", "4"],
     "do not split"),
    (["--comm", "hier", "--data-axis", "3"], "do not split"),
    (["--comm", "pipe-int8", "--data-axis", "4", "--pipe-stages", "3"],
     "do not split")])
def test_driver_refuses_two_tier_runs_it_cannot_run(flags, err, capsys):
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--reduced", "--device", "cpu", *flags])
    assert err in capsys.readouterr().err
    with pytest.raises(ValueError, match="do not split"):
        Trainer(get_reduced(ARCH), RankGroup.make(3, "cpu"), comm="hier")
    with pytest.raises(NotImplementedError, match="overlap"):
        B.resolve("hier", "overlap")
    assert B.resolve("pipe", "minibatch") == (B.PIPE, "1f1b")
    assert B.resolve("pipe-int8", "layer") == (B.PIPE_INT8, "1f1b")
    # pipe implies 1f1b under any schedule, overlap included
    assert train_cli.parse_args(["--reduced", "--comm", "pipe",
                                 "--schedule", "overlap"]).inter == 2
