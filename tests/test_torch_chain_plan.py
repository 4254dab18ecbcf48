"""The chained rings' launch plan (``repro_torch.kernels._ring.chain_plan``)
on the CPU: the tile size, the slots, the shared memory, the slice each
cluster carries and the grid, as the wrappers of ``odc_gather_layers`` and
``odc_scatter_accumulate_layers`` pass them to their cluster kernels.  The
plan is a pure function of (c, element size, n, co-resident clusters), so
it is checked here for every ring size the kernels take, against an H100's
132 SMs."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _ring

torch.set_num_threads(1)

H100_SMS = 132
MAX_BLOCK_SHARED_BYTES = 232_448  # the most one H100 block may take
QWEN_TRUNK_C = 23_397_888  # qwen-1.5b's packed trunk, per layer and rank


def _tiles(plan, c, es):
    """Every (start, end) tile the kernel walks, in cluster order: cluster
    b's slice of c from min(b * slice, c), cut in tiles of tile_bytes (as
    odc_chain_slice in csrc/odc_cluster.cuh)."""
    te = plan.tile_bytes // es
    starts, ends = [], []
    for b in range(plan.blocks_per_rank):
        lo = min(b * plan.slice_elems, c)
        hi = min(lo + plan.slice_elems, c)
        s = np.arange(lo, hi, te, dtype=np.int64)
        starts.append(s)
        ends.append(np.minimum(s + te, hi))
    return np.concatenate(starts), np.concatenate(ends)


@pytest.mark.parametrize("kind", ["gather", "scatter"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_covers_c_once_in_aligned_tiles_within_the_share(kind, dtype):
    es = torch.empty(0, dtype=dtype).element_size()
    for n in range(1, _ring.MAX_RANKS + 1):
        clusters = H100_SMS * _ring.CHAIN_BLOCKS_PER_SM // n
        te = _ring.chain_layout(kind, n).tile_bytes // es
        for c in (1, 7, 1003, te - 1, te, te + 1, QWEN_TRUNK_C):
            plan = _ring.chain_plan(kind, c, es, n, clusters)
            tag = f"{kind} {dtype} n={n} c={c}: {plan}"
            assert plan.smem_bytes <= MAX_BLOCK_SHARED_BYTES, tag
            assert plan.smem_bytes == _ring.chain_smem_bytes(
                n, plan.tile_bytes, plan.own_slots, plan.first_slots,
                plan.recv_depth), tag
            assert plan.tile_bytes % 128 == 0 and plan.tile_bytes >= 128, tag
            # the grid: at most 1/CHAIN_SHARE of the card's blocks
            assert 1 <= plan.blocks_per_rank <= clusters, tag
            assert plan.blocks_per_rank * n <= \
                clusters * n // _ring.CHAIN_SHARE, tag
            # every element of c in exactly one (cluster, tile)
            starts, ends = _tiles(plan, c, es)
            assert starts[0] == 0 and ends[-1] == c, tag
            assert np.array_equal(starts[1:], ends[:-1]), tag
            assert (ends > starts).all() and (ends - starts <= te).all(), tag
            # tile starts 16-byte aligned within the row
            assert (starts * es % 16 == 0).all(), tag
            assert plan.slice_elems * es % 16 == 0, tag


def test_plan_layout_fits_the_block_share_of_an_sm():
    """Each kernel's blocks are sized so that CHAIN_BLOCKS_PER_SM of them
    fit in one SM's shared memory, whatever c, the type and n are; every
    hop has a recv slot, and the scatter a first slot past one rank."""
    per_sm = _ring.CHAIN_BLOCKS_PER_SM
    for kind in ("gather", "scatter"):
        for n in range(1, _ring.MAX_RANKS + 1):
            lay = _ring.chain_layout(kind, n)
            assert per_sm * (lay.smem_bytes + _ring.BLOCK_RESERVED_BYTES) \
                <= _ring.SM_SHARED_BYTES
            assert lay.own_slots >= 2 and lay.recv_depth >= 1
            assert lay.first_slots >= (kind == "scatter" and n > 1)
            for es in (2, 4):
                plan = _ring.chain_plan(kind, 10 ** 6, es, n, 66)
                assert (plan.tile_bytes, plan.smem_bytes) == \
                    (lay.tile_bytes, lay.smem_bytes)


def test_plan_takes_a_grid_and_refuses_a_card_without_a_cluster():
    plan = _ring.chain_plan("gather", QWEN_TRUNK_C, 4, 2, 528,
                            blocks_per_rank=528)
    assert plan.blocks_per_rank == 528
    starts, ends = _tiles(plan, QWEN_TRUNK_C, 4)
    assert starts[0] == 0 and ends[-1] == QWEN_TRUNK_C
    assert np.array_equal(starts[1:], ends[:-1])
    # a small layer takes one cluster
    assert _ring.chain_plan("scatter", 100, 2, 8, 132).blocks_per_rank == 1
    with pytest.raises(RuntimeError, match="cannot hold one cluster"):
        _ring.chain_plan("scatter", 100, 4, 16, 0)
