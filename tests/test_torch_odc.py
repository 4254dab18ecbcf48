"""The port's ODC rings against the JAX package's, on the CPU.

``repro_torch.core.odc`` runs every rank of a ring in one process over a
per-rank list; it is held to ``repro.core.odc`` under ``shard_map`` on the
fake host devices (``ring_gather``, ``ring_scatter_accumulate``,
``collective_gather``, ``collective_scatter``), natural and
``DeviceProfile``-ordered rings, and to the Pallas ring kernels
(``repro.kernels.ops.odc_gather`` / ``odc_scatter_accumulate``, natural
ring only) in interpret mode.  The port's kernel wrappers take these
plain rings on CPU tensors.  Inputs are numpy arrays from a seed.

Tolerance: none.  The gathers move data, and both scatter-accumulates add
in the same hop order (``acc = arrived + own``), so the results are
bitwise equal in float32.  The collective reduce-scatter sums in rank
order, which XLA's host ``psum_scatter`` also does here: bitwise too.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro.balance import make_straggler_profile as jprofile
from repro.core import odc as jodc
from repro.kernels import ops
from repro_torch.balance.cost import make_straggler_profile as tprofile
from repro_torch.core import odc as todc
from repro_torch.kernels import odc_gather as kgather
from repro_torch.kernels import odc_scatter as kscatter

NS = (2, 3, 4)


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("data",))


def _run(fn, x, n):
    """fn inside shard_map over n devices; x is the stack of the ranks'
    inputs (n, ...).  Returns the ranks' outputs stacked (n, ...)."""
    f = jax.jit(jax.shard_map(lambda xd: fn(xd[0])[None], mesh=_mesh(n),
                              in_specs=P("data"), out_specs=P("data"),
                              check_vma=False))
    return np.asarray(f(x))


def _profile(n):
    return jprofile("uniform", n, slow_factor=2.0, seed=0), \
        tprofile("uniform", n, slow_factor=2.0, seed=0)


def _shards(seed, n, c, tail=(3,)):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, c) + tail).astype(np.float32)


def _assert_bitwise(ours, ref):
    ours = np.stack([t.numpy() for t in ours])
    assert ours.shape == ref.shape
    assert np.array_equal(ours.view(np.int32), ref.view(np.int32))


def test_profile_orders_are_copies():
    """The copied DeviceProfile gives the JAX package's ring orders, and
    the profiles used below walk a ring other than the natural one."""
    for n in NS + (8,):
        jp, tp = _profile(n)
        assert tp.ring_order() == jp.ring_order()
        assert todc.ring_order(n, tp) == tp.ring_order()
    assert todc.ring_order(4, None) is None
    assert todc.ring_order(4, _profile(2)[1]) is None  # size mismatch


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("ordered", [False, True], ids=["natural", "profile"])
def test_ring_gather_bitwise(n, ordered):
    jp, tp = _profile(n) if ordered else (None, None)
    x = _shards(n, n, 5)
    ref = _run(lambda s: jodc.ring_gather(s, "data", device_profile=jp), x, n)
    order = todc.ring_order(n, tp)
    ours = todc.ring_gather([torch.from_numpy(s) for s in x], order)
    _assert_bitwise(ours, ref)
    wrapped = kgather.odc_gather([torch.from_numpy(s) for s in x], order)
    _assert_bitwise(wrapped, ref)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("ordered", [False, True], ids=["natural", "profile"])
def test_ring_scatter_accumulate_bitwise(n, ordered):
    jp, tp = _profile(n) if ordered else (None, None)
    y = _shards(10 + n, n, 4 * n)
    ref = _run(lambda s: jodc.ring_scatter_accumulate(
        s, "data", device_profile=jp), y, n)
    order = todc.ring_order(n, tp)
    ours = todc.ring_scatter_accumulate([torch.from_numpy(s) for s in y],
                                        order)
    _assert_bitwise(ours, ref)
    wrapped = kscatter.odc_scatter_accumulate(
        [torch.from_numpy(s) for s in y], order)
    _assert_bitwise(wrapped, ref)


@pytest.mark.parametrize("n", NS)
def test_collectives_bitwise(n):
    x = _shards(20 + n, n, 3)
    ref = _run(lambda s: jodc.collective_gather(s, "data"), x, n)
    _assert_bitwise(todc.collective_gather([torch.from_numpy(s) for s in x]),
                    ref)
    y = _shards(30 + n, n, 2 * n)
    ref = _run(lambda s: jodc.collective_scatter(s, "data"), y, n)
    _assert_bitwise(todc.collective_scatter([torch.from_numpy(s) for s in y]),
                    ref)


@pytest.mark.parametrize("n", NS)
def test_rings_match_the_pallas_kernels(n):
    """The TPU ring kernels in interpret mode (natural ring: the Pallas
    kernels take no ring order) give what the port's plain rings give."""
    x = _shards(40 + n, n, 4, tail=(8,))
    ref = _run(lambda s: ops.odc_gather(s, "data", interpret=True), x, n)
    _assert_bitwise(kgather.odc_gather([torch.from_numpy(s) for s in x]),
                    ref)
    y = _shards(50 + n, n, 2 * n, tail=(8,))
    ref = _run(lambda s: ops.odc_scatter_accumulate(s, "data",
                                                    interpret=True), y, n)
    _assert_bitwise(
        kscatter.odc_scatter_accumulate([torch.from_numpy(s) for s in y]),
        ref)


def test_world_one_and_bad_orders():
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(todc.ring_gather([x])[0], x)
    assert torch.equal(todc.ring_scatter_accumulate([x])[0], x)
    with pytest.raises(ValueError, match="permutation"):
        todc.ring_gather([x, x], [0, 0])
