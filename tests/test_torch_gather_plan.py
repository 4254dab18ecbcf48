"""Plan of the single-leaf ODC gathers, on the CPU.

On the card the gather (``repro_torch.kernels.odc_gather.odc_gather``)
and the q8 gather (``repro_torch.kernels.quant.gather_codes``) are one
read-once broadcast (``csrc/odc_bcast.cuh``): block (b, s) reads slice b
of shard s once and stores it to row s of every rank's output, with no
ring.  Checked here:

* the default grid of the three pull kernels (rows 1, 3 and 9),
  ``_ring.pull_blocks_per_rank``: at least one block, at most its waves
  of the card's co-resident blocks over all n sources; and that the
  header's threads and unroll are the ones the plan assumes;
* the kernel's arithmetic (``odc_bcast``, ``odc_bcast_range``), mirrored
  in this file: ``broadcast_spans``, the head, body and tail of every
  block's range: every byte of an output row covered exactly once, each
  span's words aligned on both sides, for c in {1, 7, 1001, 4099},
  float32 and bfloat16, and source and destination offsets of 0, 2, 4
  and 8 mod 16; and the q8 gather's codes and scales cut into the same
  chunks;
* ``broadcast_plain``, the mirror's copy moving a CPU tensor's bytes
  along those spans from the tensors' own addresses (sources at storage
  offsets), bitwise equal to the JAX package's ring
  (``repro.core.odc.ring_gather`` under ``jax.vmap`` with a named axis, so
  that 16 ranks need no 16 devices) over n in {1, 2, 3, 4, 8, 16}, the
  natural and the reversed ring, float32, bfloat16, int32 bits with NaN
  patterns (as cp sends them, in float32 views), and the q8 codes and
  scales; and to the JAX package's Pallas q8 gather in interpret mode
  under ``shard_map`` (n = 2, 4).  Tolerance: none (the gather moves
  bytes).

The mirror is not the kernel: the kernel itself is held against the
plain ring (the wrapper's CPU route, bitwise the JAX ring here) by the
card tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py``.
"""
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro.balance import DeviceProfile
from repro.core import odc as jodc
from repro.kernels import quant as jquant
from repro_torch.core import odc
from repro_torch.kernels import _ring
from repro_torch.kernels import odc_gather as G
from repro_torch.kernels import odc_scatter as S

# blocks of 256 threads an H100 holds at once: 8 on each of 132 SMs
CAP = 8 * 132
W_UP_BYTES = 28 * 768 * 8960 * 4
OFFSETS = (0, 2, 4, 8)
HEADER = (pathlib.Path(_ring.__file__).parent / "csrc" / "odc_bcast.cuh")


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
# (a) the pull kernels' grid
# ===========================================================================
@pytest.mark.parametrize("n", [1, 2, 4, 16])
@pytest.mark.parametrize("kind", ["gather", "q8"])
def test_gather_grid_is_within_its_waves(kind, n):
    """The gathers' default grid (the bytes of a leaf; of its codes for
    the q8 gather): one block per 256 threads x 4 vectors, at most
    PULL_WAVES waves of the card over the n sources, at least one; and
    the scatter's grid is the same function at its own unroll."""
    waves = _ring.PULL_WAVES
    for nbytes in (4, 2002, 2 ** 26, W_UP_BYTES):
        if kind == "q8":  # float32 values -> whole 256-value chunks
            nbytes = math.ceil(nbytes / 4 / 256) * 256
        b = _ring.pull_blocks_per_rank(nbytes, n, CAP, _ring.BCAST_UNROLL)
        assert 1 <= b and (b * n <= waves * CAP or b == 1)
        vectors = math.ceil(nbytes / 16)
        assert b == max(1, min(math.ceil(vectors / (
            _ring.PULL_THREADS * _ring.BCAST_UNROLL)), waves * CAP // n))
        assert S.pull_blocks_per_rank(nbytes, 1, n, CAP) == \
            _ring.pull_blocks_per_rank(nbytes, n, CAP, S.PULL_UNROLL)


@pytest.mark.parametrize("name,value", [
    ("ODC_BCAST_THREADS", _ring.PULL_THREADS),
    ("ODC_BCAST_UNROLL", _ring.BCAST_UNROLL)])
def test_header_constants_are_the_plans(name, value):
    """The kernel's block size and unroll, plain defines in its header,
    are the ones the host's grid plan counts with."""
    text = HEADER.read_text()
    assert re.findall(rf"^#define {name} (\d+)$", text, re.M) == [str(value)]


# ===========================================================================
# (b) the spans of a block's range
# ===========================================================================
def block_range(units: int, blocks: int, b: int):
    """Units [lo, hi) of a shard that block b of ``blocks`` takes
    (``odc_bcast``)."""
    per = -(-units // blocks)
    lo = min(b * per, units)
    return lo, min(lo + per, units)


def copy_spans(lo: int, hi: int, src_mod: int, dst_mod: int):
    """How ``odc_bcast_range`` copies bytes [lo, hi) of a source that
    starts at ``src_mod`` mod 16 into a destination that starts at
    ``dst_mod`` mod 16: ``(start, length, word)`` spans, a head of bytes up
    to the destination's 16-byte boundary, a body of the widest words (16,
    8, 4, 2 or 1 bytes) at which the source is aligned there too, and a
    tail of bytes; empty spans left out."""
    head = min(hi, lo + (-(dst_mod + lo)) % 16)
    mis = (src_mod + head) % 16
    word = 16 if mis == 0 else mis & -mis
    tail = head + (hi - head) // word * word
    spans = ((lo, head - lo, 1), (head, tail - head, word),
             (tail, hi - tail, 1))
    return [sp for sp in spans if sp[1] > 0]


def broadcast_spans(nbytes: int, src_mod: int, dst_mod: int, blocks: int,
                    unit: int = 16):
    """For each of a source's ``blocks`` blocks, its ``copy_spans`` of a
    shard of ``nbytes`` bytes cut into units of ``unit`` bytes (16 for a
    leaf; a chunk's 256 code bytes or its 4 scale bytes for the q8
    gather, whose two payloads have as many units)."""
    units = -(-nbytes // unit)
    spans = []
    for b in range(blocks):
        lo, hi = block_range(units, blocks, b)
        spans.append(copy_spans(lo * unit, min(hi * unit, nbytes), src_mod,
                                dst_mod))
    return spans


def broadcast_plain(shards, outs, blocks: int, unit: int = 16):
    """The kernel's copy on CPU tensors, byte for byte: shard s into row s
    of every output, block by block along ``broadcast_spans`` from the
    tensors' own addresses.  Fills and returns ``outs``."""
    dst = [o.reshape(-1).view(torch.uint8) for o in outs]
    assert len({o.data_ptr() % 16 for o in outs}) == 1
    for s, shard in enumerate(shards):
        src = shard.reshape(-1).view(torch.uint8)
        row = src.numel()
        for spans in broadcast_spans(row, shard.data_ptr() % 16,
                                     (outs[0].data_ptr() + s * row) % 16,
                                     blocks, unit):
            for start, length, _ in spans:
                for d in dst:
                    d[s * row + start:s * row + start + length] = \
                        src[start:start + length]
    return outs


def _check_cover(spans_by_block, nbytes, src_mod, dst_mod):
    """Every byte of [0, nbytes) in exactly one span; each span a whole
    number of its words, aligned at both ends; returns the spans."""
    spans = sorted(sp for block in spans_by_block for sp in block)
    at = 0
    for start, length, word in spans:
        assert start == at and length > 0
        assert word in (1, 2, 4, 8, 16) and length % word == 0
        assert (src_mod + start) % word == 0 == (dst_mod + start) % word
        at += length
    assert at == nbytes
    return spans


@pytest.mark.parametrize("src_mod", OFFSETS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [1, 7, 1001, 4099])
def test_broadcast_spans_cover_every_byte_once(c, dtype, src_mod):
    """A leaf of c elements, its source at ``src_mod`` and its output row
    at each of the offsets, on grids of 1, 3, 7 and 64 blocks: every byte
    once; the body in 16-byte words wherever source and destination agree
    mod 16 (a head and a tail under 16 bytes each a block)."""
    nbytes = c * torch.empty(0, dtype=dtype).element_size()
    for dst_mod in OFFSETS:
        for blocks in (1, 3, 7, 64):
            by_block = broadcast_spans(nbytes, src_mod, dst_mod, blocks)
            assert len(by_block) == blocks
            _check_cover(by_block, nbytes, src_mod, dst_mod)
            if src_mod == dst_mod:
                for block in by_block:
                    assert all(word == 16 or length < 16
                               for _, length, word in block)


@pytest.mark.parametrize("nc", [1, 37, 1000])
def test_q8_spans_keep_each_scale_with_its_chunk(nc):
    """The q8 gather's two payloads, 256 code bytes and 4 scale bytes a
    chunk, are cut into the same chunks: block b carries chunk k's codes
    exactly when it carries chunk k's scale; both cover their rows once
    (rank s's scales land at s * nc * 4 bytes into an output)."""
    for blocks in (1, 3, 7, 64):
        for s in range(4):
            dst_mod = s * nc * 4 % 16
            codes = broadcast_spans(nc * 256, 0, 0, blocks, unit=256)
            scales = broadcast_spans(nc * 4, 0, dst_mod, blocks,
                                           unit=4)
            _check_cover(codes, nc * 256, 0, 0)
            _check_cover(scales, nc * 4, 0, dst_mod)
            for cb, sb in zip(codes, scales):
                chunks = {k for st, ln, _ in cb
                          for k in range(st // 256, (st + ln) // 256)}
                assert chunks == {k for st, ln, _ in sb
                                  for k in range(st // 4, (st + ln) // 4)}


# ===========================================================================
# (c) the kernel's copy against the JAX rings
# ===========================================================================
NAN_BITS = np.array([0x7FC00001, 0x7F800001, -1, 0x7F800000, -0x00400001,
                     0x7FBFFFFF], dtype=np.int32)
# the integer type whose bits a float type's are compared as
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _at_offset(t: torch.Tensor, k: int) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts k elements into its storage
    (a source off 16 bytes, as a view can be)."""
    buf = torch.zeros(t.numel() + k, dtype=t.dtype)
    buf[k:] = t.reshape(-1)
    return buf[k:].view(t.shape)


def _jax_ring(xs: np.ndarray, reversed_order: bool) -> np.ndarray:
    """The JAX package's ring gather of each rank's xs[r], every rank
    under one ``jax.vmap`` over a named axis; the reversed ring through a
    DeviceProfile whose speeds rise with the rank."""
    n = xs.shape[0]
    profile = (DeviceProfile(speeds=tuple(1.0 + d for d in range(n)))
               if reversed_order else None)
    out = jax.vmap(lambda v: jodc.ring_gather(v, "data",
                                              device_profile=profile),
                   axis_name="data")(xs)
    bits = {jnp.dtype(jnp.float32): jnp.int32,
            jnp.dtype(jnp.bfloat16): jnp.int16}.get(out.dtype)
    return np.asarray(out if bits is None
                      else jax.lax.bitcast_convert_type(out, bits))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(BITS.get(t.dtype, t.dtype)).numpy()


def _mirror(shards, blocks, unit=16):
    n = len(shards)
    x = shards[0]
    outs = [torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                        dtype=x.dtype) for _ in range(n)]
    return broadcast_plain(shards, outs, blocks, unit)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int32", "q8"])
@pytest.mark.parametrize("reversed_order", [False, True],
                         ids=["natural", "reversed"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 16])
def test_broadcast_is_bitwise_the_jax_ring(n, reversed_order, kind):
    """Sources at storage offsets r mod 4 (off 16 bytes), grids of 1, 3
    and 7 blocks: the mirror's outputs equal the JAX ring's bit for bit,
    whatever the ring order; so does the plain ring, the wrapper's CPU
    route.  int32 leaves (half NaN and infinity patterns) travel as
    float32 views, as cp sends its segment ids."""
    rng = np.random.default_rng(1000 * n + len(kind))
    order = list(reversed(range(n))) if reversed_order else None
    if kind == "q8":
        enc = [odc.quantize_chunked(torch.from_numpy(
            rng.normal(size=(300,)).astype(np.float32))) for _ in range(n)]
        qs = [_at_offset(q, r % 4) for r, (q, _) in enumerate(enc)]
        ss = [_at_offset(s, r % 4) for r, (_, s) in enumerate(enc)]
        want = [_jax_ring(np.stack([t.numpy() for t in ts]), reversed_order)
                for ts in (qs, ss)]
        for blocks in (1, 3, 7):
            for ts, unit, ref in ((qs, 256, want[0]), (ss, 4, want[1])):
                for r, out in enumerate(_mirror(ts, blocks, unit)):
                    np.testing.assert_array_equal(_bits(out), ref[r])
        q_out, s_out = G.odc_gather_plain(qs, order), \
            G.odc_gather_plain(ss, order)
        for r in range(n):
            np.testing.assert_array_equal(_bits(q_out[r]), want[0][r])
            np.testing.assert_array_equal(_bits(s_out[r]), want[1][r])
        return
    x = rng.normal(size=(n, 7, 3)).astype(np.float32)
    if kind == "int32":
        x = rng.integers(-2 ** 31, 2 ** 31, size=(n, 7, 3), dtype=np.int32)
        x.reshape(-1)[::2] = np.resize(NAN_BITS, x.reshape(-1)[::2].size)
        ref = _jax_ring(x, reversed_order)
        shards = [_at_offset(torch.from_numpy(v), r % 4).view(torch.float32)
                  for r, v in enumerate(x)]
    else:
        dtype = torch.float32 if kind == "f32" else torch.bfloat16
        ref = _jax_ring(jnp.asarray(x).astype(
            jnp.float32 if kind == "f32" else jnp.bfloat16), reversed_order)
        shards = [_at_offset(torch.from_numpy(v).to(dtype), r % 4)
                  for r, v in enumerate(x)]
        for r, out in enumerate(G.odc_gather_plain(shards, order)):
            np.testing.assert_array_equal(_bits(out), ref[r])
    assert {s.data_ptr() % 16 for s in shards} != {0} or n == 1
    for blocks in (1, 3, 7):
        for r, out in enumerate(_mirror(shards, blocks)):
            assert out.dtype == shards[0].dtype and out.shape == (7 * n, 3)
            np.testing.assert_array_equal(_bits(out), ref[r])


@pytest.mark.parametrize("n", [2, 4])
def test_q8_broadcast_is_bitwise_the_pallas_kernel(n):
    """The mirror over codes and scales against the JAX package's Pallas
    q8 gather (interpret mode, under shard_map on n host devices):
    (n, n_chunks, 256) codes and (n, n_chunks, 1) scales, bitwise."""
    rng = np.random.default_rng(20 + n)
    enc = [odc.quantize_chunked(torch.from_numpy(
        rng.normal(size=(16, 37)).astype(np.float32))) for _ in range(n)]
    qs, ss = [q for q, _ in enc], [s for _, s in enc]
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    qj, sj = jax.jit(jax.shard_map(
        lambda q, sc: tuple(a[None] for a in jquant.odc_gather_q8_pallas(
            q[0], sc[0], axis_name="data", interpret=True)),
        mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data")), check_vma=False))(
        jnp.asarray(np.stack([q.numpy() for q in qs])),
        jnp.asarray(np.stack([s.numpy() for s in ss])))
    nc = qs[0].shape[0]
    for blocks in (1, 2):
        q_out = _mirror(qs, blocks, 256)
        s_out = _mirror(ss, blocks, 4)
        for r in range(n):
            np.testing.assert_array_equal(q_out[r].view(n, nc, 256).numpy(),
                                          np.asarray(qj[r]))
            np.testing.assert_array_equal(
                _bits(s_out[r].view(n, nc, 1)),
                np.asarray(sj[r]).view(np.int32))
