"""The port's ``kernels.gather_matmul`` against the JAX package, on the CPU.

On CPU tensors the wrapper runs its plain version, the kernel's hop order
in PyTorch.  The JAX side is ``ops.gather_matmul(..., interpret=True)``
(the Pallas ring kernel in interpret mode) under ``shard_map`` over a
ring of host devices, each rank with its own x, so that every rank's f32
sum (in its own hop order) comes back as its own output
(``out_specs=P("x", None)`` over the stacked result); and the oracle
``ref.gather_matmul_ref`` (x @ the all-gathered W) the same way.

Tolerances: float32 within 1e-5 (XLA and PyTorch sum each hop's k/n-term
dot in another order); bfloat16 within 1e-2 (both sum the exact products
of bf16 inputs in f32 and round once to bf16: at most one bf16 step,
2**-7 relative, apart).  Inputs are numpy arrays from a seed, handed to
both packages.  One torch thread per test.
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

from repro.kernels import ops, ref
from repro_torch.kernels import gather_matmul as K

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(n, m, k, f, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((n, m, k)).astype(np.float32)
    w = rng.standard_normal((k, f)).astype(np.float32)
    return xs, w


def _jax_per_rank(fn, xs, w, dtype):
    """Rank r's output of ``fn(x_local, w_shard, "x")`` under shard_map
    over n host devices, as an (n, m, f) float32 array."""
    n, m, _ = xs.shape
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))
    run = jax.jit(jax.shard_map(
        lambda x, ws: fn(x, ws, "x"), mesh=mesh,
        in_specs=(P("x", None), P("x", None)), out_specs=P("x", None),
        check_vma=False))
    out = run(jnp.asarray(xs.reshape(n * m, -1), dtype),
              jnp.asarray(w, dtype))
    return np.asarray(out.astype(jnp.float32)).reshape(n, m, -1)


def _port(xs, w, dtype):
    n = xs.shape[0]
    tdt = getattr(torch, dtype)
    tx = [torch.from_numpy(x).to(tdt) for x in xs]
    tw = [s.contiguous() for s in torch.from_numpy(w).to(tdt).chunk(n, 0)]
    outs = K.gather_matmul(tx, tw)
    assert all(o.dtype == tdt and o.shape == (xs.shape[1], w.shape[1])
               for o in outs)
    return np.stack([o.float().numpy() for o in outs])


@pytest.mark.parametrize("n,m,k,f,dtype", [
    (4, 8, 16, 8, "float32"), (4, 4, 8, 16, "float32"),
    (4, 16, 32, 8, "float32"), (2, 16, 32, 8, "float32"),
    (4, 16, 32, 8, "bfloat16")])
def test_matches_the_interpret_kernel_and_oracle_per_rank(n, m, k, f, dtype):
    xs, w = _inputs(n, m, k, f)
    jdt = getattr(jnp, dtype)
    got = _port(xs, w, dtype)
    want = _jax_per_rank(
        lambda x, s, a: ops.gather_matmul(x, s, a, interpret=True), xs, w,
        jdt)
    oracle = _jax_per_rank(ref.gather_matmul_ref, xs, w, jdt)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, oracle, rtol=tol, atol=tol)
    assert np.isfinite(got).all()


def test_hop_order_is_each_ranks_own():
    """Rank r adds the shards in the order r, r-1, ...: with values whose
    f32 sum depends on the order, each rank's output is the sum in its own
    order, exactly."""
    n, m, c, f = 4, 1, 1, 1
    xs = [torch.ones((m, n * c)) for _ in range(n)]
    vals = [1.0, 2.0 ** -24, -1.0, 2.0 ** -24]
    shards = [torch.full((c, f), v) for v in vals]
    outs = K.gather_matmul(xs, shards)
    for r, o in enumerate(outs):
        acc = torch.zeros((), dtype=torch.float32)
        for i in range(n):
            acc = acc + vals[(r - i) % n]
        assert o.item() == acc.item()
    assert len({o.item() for o in outs}) > 1


def test_refusals():
    x = [torch.zeros(4, 8), torch.zeros(4, 8)]
    w = [torch.zeros(4, 3), torch.zeros(4, 3)]
    assert [o.shape for o in K.gather_matmul(x, w)] == [(4, 3)] * 2
    with pytest.raises(ValueError, match="k = 8 columns"):
        K.gather_matmul(x, [torch.zeros(3, 3), torch.zeros(3, 3)])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.gather_matmul([t.half() for t in x], [t.half() for t in w])
    with pytest.raises(ValueError, match="contiguous"):
        K.gather_matmul([torch.zeros(8, 4).T, x[1]], w)
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        K.gather_matmul([x[0], torch.zeros(4, 8, device="meta")], w)
    with pytest.raises(ValueError, match="same shape"):
        K.gather_matmul(x, [w[0], torch.zeros(4, 5)])
    with pytest.raises(ValueError, match="ranks of x"):
        K.gather_matmul(x, w[:1])
    assert K.launches == 0  # CPU tensors never reach the kernel
