// The read-once broadcast of the single-leaf ODC gathers: the ring
// all-gather of one leaf (odc_gather.cu, odc_gather_kernel) and of its int8
// encoding (odc_q8.cu, odc_gather_q8_kernel), every rank on this card, in
// one plain launch.  Each file defines its own kernel over odc_bcast<P>
// (P payloads), so that a trace tells the two apart.
//
// A gather is pure data movement, and its result does not depend on the
// ring order: row s of every rank's output is shard s.  Every rank's
// buffer lies behind one pointer table here, so no hop is needed.  Block
// (b, s) of the grid (blocks_per_rank, n) reads slice b of SOURCE shard s
// once, U 16-byte vectors in flight a thread (ld.global.nc, __ldg), and
// stores each vector to row s of all n outputs with the streaming hint
// (__stcs).  Device memory sees n * c bytes read and n^2 * c written,
// which is the gather's least traffic.  No block waits for another: no
// staging, flags, credits or epoch, no cooperative launch, and any grid of
// at least one block gives the same bits.
//
// A payload is one stream of bytes a shard carries: the leaf itself
// (row 1), or the codes and the scales of its encoding (row 9).  A shard is
// cut into `units` units (16 bytes of a leaf; one 256-value chunk of the
// encoding, 256 bytes of codes and 4 of scales), and block b takes units
// [lo, hi) of every payload, so that a chunk's scale travels with its
// codes.
//
// Bytes, never floats: every load and store moves integer words, so an
// int32 leaf sent as float32 bits (cp's segment ids) comes out bit for bit,
// NaN patterns included.  Alignment differs per source: the destination
// row s * row bytes into an output is off 16 bytes whenever row % 16 != 0,
// and a source shard may start anywhere.  So each range [lo, hi) is copied
// as a head of bytes up to the destination's 16-byte boundary, a body of
// the widest words (16, 8, 4, 2 or 1 bytes) at which the source is aligned
// there too, and a tail of bytes (tests/test_torch_gather_plan.py mirrors
// this arithmetic on the CPU).  The outputs are fresh allocations,
// congruent mod 16, so one head serves every destination.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "odc_ring.cuh"

// Threads of a block (_ring.PULL_THREADS); 16-byte vectors a thread holds
// between its load and its n stores (_ring.BCAST_UNROLL, which sizes the
// default grid); blocks an SM must hold at once (4: at most 64 registers a
// thread, where the compiler would take 144 and leave one block of 256
// threads an SM).
#define ODC_BCAST_THREADS 256
#define ODC_BCAST_UNROLL 4
#define ODC_BCAST_MIN_BLOCKS 4
#define ODC_BCAST_PAYLOADS 2

struct OdcBcastArgs {
  const unsigned char* in[ODC_BCAST_PAYLOADS][ODC_MAX_RANKS];  // shard s
  unsigned char* out[ODC_BCAST_PAYLOADS][ODC_MAX_RANKS];  // (n, row) bytes
  long long row[ODC_BCAST_PAYLOADS];   // bytes of one shard
  long long unit[ODC_BCAST_PAYLOADS];  // bytes of one unit
  long long units;                     // units of a shard, every payload
  int n;
};

// `words` words of V from src + at into dst[r] + at for every r
template <typename V>
__device__ __forceinline__ void odc_bcast_words(const unsigned char* src,
                                                unsigned char* const* dst,
                                                int n, long long at,
                                                long long words) {
  constexpr int U = ODC_BCAST_UNROLL;
  const V* s = reinterpret_cast<const V*>(src + at);
  for (long long base = threadIdx.x; base < words;
       base += (long long)ODC_BCAST_THREADS * U) {
    V v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + (long long)u * ODC_BCAST_THREADS;
      if (i < words) v[u] = __ldg(s + i);
    }
    for (int r = 0; r < n; ++r) {
      V* d = reinterpret_cast<V*>(dst[r] + at);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long i = base + (long long)u * ODC_BCAST_THREADS;
        if (i < words) __stcs(d + i, v[u]);
      }
    }
  }
}

// Bytes [lo, hi) of src into [lo, hi) of every dst[r]
__device__ __forceinline__ void odc_bcast_range(const unsigned char* src,
                                                unsigned char* const* dst,
                                                int n, long long lo,
                                                long long hi) {
  long long head =
      lo + (long long)((16u - ((uintptr_t)(dst[0] + lo) & 15u)) & 15u);
  if (head > hi) head = hi;
  const unsigned mis = (unsigned)((uintptr_t)(src + head) & 15u);
  const int w = mis == 0 ? 16 : (int)(mis & (0u - mis));
  const long long words = (hi - head) / w, tail = head + words * w;
  switch (w) {
    case 16: odc_bcast_words<uint4>(src, dst, n, head, words); break;
    case 8: odc_bcast_words<uint2>(src, dst, n, head, words); break;
    case 4: odc_bcast_words<unsigned>(src, dst, n, head, words); break;
    case 2: odc_bcast_words<unsigned short>(src, dst, n, head, words); break;
    default: odc_bcast_words<unsigned char>(src, dst, n, head, words);
  }
  // the head, then the tail, a byte at a time
  const long long nh = head - lo, nb = nh + (hi - tail);
  for (long long i = threadIdx.x; i < nb; i += ODC_BCAST_THREADS) {
    const long long at = i < nh ? lo + i : tail + (i - nh);
    const unsigned char v = __ldg(src + at);
    for (int r = 0; r < n; ++r) dst[r][at] = v;
  }
}

// The body of a broadcast kernel over P payloads: block (b, s) copies
// units [lo, hi) of shard s into row s of every output.
template <int P>
__device__ __forceinline__ void odc_bcast(const OdcBcastArgs& a) {
  const int n = a.n, s = blockIdx.y;
  const long long per = (a.units + gridDim.x - 1) / gridDim.x;
  long long lo = (long long)blockIdx.x * per, hi = lo + per;
  if (lo >= a.units) return;
  if (hi > a.units) hi = a.units;
  // row s of every output, for each payload
  __shared__ unsigned char* dst[P][ODC_MAX_RANKS];
  if (threadIdx.x < n) {
#pragma unroll
    for (int p = 0; p < P; ++p)
      dst[p][threadIdx.x] = a.out[p][threadIdx.x] + (long long)s * a.row[p];
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < P; ++p) {
    long long l = lo * a.unit[p], h = hi * a.unit[p];
    if (h > a.row[p]) h = a.row[p];
    if (l < h) odc_bcast_range(a.in[p][s], dst[p], n, l, h);
  }
}

// Blocks of a broadcast kernel `fn` the card holds at once.
static inline int odc_bcast_capacity(const void* fn, int* blocks) {
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, ODC_BCAST_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  *blocks = per_sm * sms;
  return 0;
}

// Payload p of a launch (host side): n ranks' shards and outputs, `row`
// bytes a shard in units of `unit` bytes.  False when the outputs are not
// congruent mod 16 (one head serves every destination).
static inline bool odc_bcast_payload(OdcBcastArgs* a, int p,
                                     const void* const* in,
                                     void* const* out, int n, long long row,
                                     long long unit) {
  for (int r = 0; r < n; ++r) {
    a->in[p][r] = static_cast<const unsigned char*>(in[r]);
    a->out[p][r] = static_cast<unsigned char*>(out[r]);
    if ((((uintptr_t)out[r]) & 15u) != (((uintptr_t)out[0]) & 15u))
      return false;
  }
  a->row[p] = row;
  a->unit[p] = unit;
  a->n = n;
  return true;
}
