"""Host-side plans of two hand-written kernels, on the CPU.

The single-leaf ODC scatter-accumulate (``repro_torch.kernels.odc_scatter``)
runs on the card as an owner-side pull: owner o reads chunk o of every
rank's contribution and sums it in a fixed order.
``odc_scatter_accumulate_owner_plain`` is that order written in PyTorch;
here it is held bitwise to the plain ring (``odc_scatter_accumulate_plain``
= ``repro_torch.core.odc.ring_scatter_accumulate``) and to the JAX
package's ring (``repro.core.odc.ring_scatter_accumulate``, run under
``jax.vmap`` with a named axis, so that 16 ranks need no 16 devices), on
numpy inputs from a seed, over n in {1, 2, 3, 4, 8, 16}, the natural and
the reversed ring, float32 and bfloat16, and c in {1, 7, 4099}.
Tolerance: none (the same adds in the same order, each rounded to the
input type).

``gather_matmul``'s route (tensor cores or CUDA cores) and tile plan
(``repro_torch.kernels.gather_matmul.route`` / ``launch_plan``) are pure
functions of the shapes, the dtype and the pointers' alignment: checked
at ``chip_smoke.GM_CASES``, the card tests' shapes, and k, c and f at and
off TMA's 16-byte rows.
"""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.balance import DeviceProfile
from repro.core import odc as jodc
from repro_torch.kernels import gather_matmul as GM
from repro_torch.kernels import odc_scatter as S

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# the most shared memory one H100 block may take, and the static limit
MAX_BLOCK_SHARED_BYTES = 232_448
STATIC_SHARED_BYTES = 48 * 1024


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread for each test of this file, and the worker's own
    count back after it, so that no other file's numbers depend on this
    one running first."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ===========================================================================
# the pull scatter's order
# ===========================================================================
def _contributions(n, c, dtype, seed):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(n, n * c)).astype(np.float32)
    return [torch.from_numpy(r).to(dtype) for r in y]


def _jax_ring(ys, reversed_order):
    """The JAX package's ring scatter-accumulate, every rank under one
    ``jax.vmap`` over a named axis; the reversed ring through a
    DeviceProfile whose speeds rise with the rank."""
    n = len(ys)
    profile = (DeviceProfile(speeds=tuple(1.0 + d for d in range(n)))
               if reversed_order else None)
    if profile is not None:
        assert profile.ring_order() == list(reversed(range(n)))
    dtype = jnp.bfloat16 if ys[0].dtype == torch.bfloat16 else jnp.float32
    y = jnp.asarray(np.stack([t.float().numpy() for t in ys])).astype(dtype)
    out = jax.vmap(lambda v: jodc.ring_scatter_accumulate(
        v, "data", device_profile=profile), axis_name="data")(y)
    return [torch.from_numpy(np.array(out[r].astype(jnp.float32)))
            for r in range(n)]


@pytest.mark.parametrize("c", [1, 7, 4099])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("reversed_order", [False, True],
                         ids=["natural", "reversed"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 16])
def test_owner_order_is_bitwise_the_ring(n, reversed_order, dtype, c):
    ys = _contributions(n, c, dtype, seed=100 * n + c)
    order = list(reversed(range(n))) if reversed_order else None
    ours = S.odc_scatter_accumulate_owner_plain(ys, order)
    ring = S.odc_scatter_accumulate_plain(ys, order)
    for a, b in zip(ours, ring):
        assert a.dtype == dtype and a.shape == (c,)
        assert torch.equal(a, b)
    ref = _jax_ring(ys, reversed_order)
    for a, b in zip(ours, ref):
        assert np.array_equal(a.float().numpy().view(np.int32),
                              b.numpy().view(np.int32))
    # the wrapper on CPU tensors is the plain ring
    for a, b in zip(S.odc_scatter_accumulate(ys, order), ours):
        assert torch.equal(a, b)


def test_owner_order_takes_trailing_dims():
    """Contributions (n*c, ...) as the train step hands them: chunk o is
    rows o*c .. (o+1)*c - 1, whatever the trailing shape."""
    rng = np.random.default_rng(5)
    n, c = 3, 5
    ys = [torch.from_numpy(rng.normal(size=(n * c, 2, 3)).astype(np.float32))
          for _ in range(n)]
    order = [2, 0, 1]
    ours = S.odc_scatter_accumulate_owner_plain(ys, order)
    ring = S.odc_scatter_accumulate_plain(ys, order)
    assert all(a.shape == (c, 2, 3) and torch.equal(a, b)
               for a, b in zip(ours, ring))


@pytest.mark.parametrize("n", [1, 2, 4, 16])
def test_pull_grid_is_two_waves_at_most(n):
    """The default grid: one block per 256 threads x 2 vectors of a chunk,
    at most two waves of the card's co-resident blocks over all owners,
    at least one."""
    cap = 2 * 132  # two blocks of the pull kernel on each of 132 SMs
    assert S.PULL_WAVES == 2
    for c, es in ((1, 4), (1001, 2), (2 ** 24, 4), (192_675_840, 4)):
        b = S.pull_blocks_per_rank(c, es, n, cap)
        assert 1 <= b and (b * n <= 2 * cap or b == 1)
        vectors = math.ceil(c * es / 16)
        assert b == max(1, min(math.ceil(vectors / (S.PULL_THREADS
                                                    * S.PULL_UNROLL)),
                               2 * cap // n))


# ===========================================================================
# gather_matmul's route and tile plan
# ===========================================================================
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(chip_smoke.GM_CASES))
def test_main_cases_take_their_route(case, dtype):
    """Every bf16 case of chip_smoke.GM_CASES goes to the tensor cores,
    every f32 one to the CUDA cores (16-byte loads)."""
    n, m, k, f = chip_smoke.GM_CASES[case]
    plan = GM.launch_plan(n, m, k, f, dtype)
    if dtype == torch.bfloat16:
        assert plan["route"] == "tc" and plan["loads"] == "tma"
        assert (plan["bm"], plan["bn"], plan["bk"]) == (128, 256, 64)
        assert plan["threads"] == 384 and plan["stages"] >= 4
    else:
        assert plan["route"] == "simt" and plan["loads"] == "vector"
        assert (plan["bm"], plan["bn"]) == (128, 128)
        assert plan["threads"] == 256 and plan["stages"] >= 2
    assert plan["grid"] == (math.ceil(m / plan["bm"]),
                            math.ceil(f / plan["bn"]), n)
    assert plan["k_steps_per_hop"] == math.ceil(k // n / plan["bk"])


def _tma_rows(c, f, es):
    return (c * es) % 16 == 0 and (f * es) % 16 == 0


@pytest.mark.parametrize("n,m,k,f", [
    # the card tests' shapes (tests/test_torch_cuda.py)
    (2, 64, 128, 64), (4, 100, 96, 70), (3, 7, 9, 5), (2, 256, 1536, 896),
    (2, 200, 144, 256), (2, 130, 128, 200), (2, 1, 128, 64),
    (16, 96, 384, 136), (2, 64, 24, 64), (2, 40, 144, 64), (3, 40, 72, 64),
    (3, 20, 39, 24),
    # c at and off 8 bf16 (16 bytes) and 4 f32, f likewise
    (2, 128, 16, 64), (2, 128, 20, 64), (2, 128, 24, 64), (2, 128, 12, 72),
    (2, 128, 16, 68), (2, 128, 16, 66), (4, 128, 32, 8384), (1, 5, 8, 8),
    (8, 33, 8 * 4, 12), (8, 33, 8 * 2, 16)])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
def test_route_is_the_16_byte_rule(n, m, k, f, aligned):
    """bf16 goes to the tensor cores exactly when TMA can address its rows
    (c and f multiples of 16 bytes) and every pointer is 16-byte aligned;
    everything else, f32 always, to the CUDA cores, whose loads are
    16-byte vectors exactly for aligned f32 with c and f multiples of 4."""
    c = k // n
    bf = GM.launch_plan(n, m, k, f, torch.bfloat16, aligned)
    want_tc = aligned and _tma_rows(c, f, 2)
    assert bf["route"] == ("tc" if want_tc else "simt")
    assert bf["loads"] == ("tma" if want_tc else "scalar")
    assert GM.route(n, m, k, f, torch.bfloat16, aligned) == bf["route"]
    f32 = GM.launch_plan(n, m, k, f, torch.float32, aligned)
    assert f32["route"] == "simt"
    assert f32["loads"] == ("vector" if aligned and c % 4 == 0 and f % 4 == 0
                            else "scalar")
    for plan in (bf, f32):
        gx, gy, gz = plan["grid"]
        # the tiles cover the output once, with no tile wholly outside
        assert gx * plan["bm"] >= m > (gx - 1) * plan["bm"]
        assert gy * plan["bn"] >= f > (gy - 1) * plan["bn"]
        assert gz == n
        assert plan["k_steps_per_hop"] * plan["bk"] >= c


def test_shared_memory_fits_a_block():
    """The tensor-core route's 4 stages of bf16 (128 x 64) and (64 x 256)
    slices with their barriers, and the CUDA-core route's two f32 stages,
    fit one H100 block (the latter within the static 48 KB); every stage
    of the tensor-core route starts 1024-byte aligned (128-byte swizzle)."""
    tc, simt = GM.TC_TILE, GM.SIMT_TILE
    stage = 2 * tc["bk"] * (tc["bm"] + tc["bn"])
    assert stage % 1024 == 0
    assert GM.TC_SMEM_BYTES == tc["stages"] * (stage + 16) + 1024
    assert GM.TC_SMEM_BYTES <= MAX_BLOCK_SHARED_BYTES
    assert GM.SIMT_SMEM_BYTES <= STATIC_SHARED_BYTES
    # two CUDA-core blocks on one SM (launch bounds (256, 2))
    assert 2 * GM.SIMT_SMEM_BYTES <= MAX_BLOCK_SHARED_BYTES
    # wgmma: 64-row warpgroup tiles, k steps of 16 within a 128-byte row
    assert tc["bm"] == 2 * 64 and tc["bk"] * 2 == 128 and tc["bn"] % 64 == 0
