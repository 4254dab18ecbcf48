// Shared pieces of the ODC ring kernels (odc_gather.cu, odc_scatter.cu):
// the per-call argument block, the flag protocol and the copy helpers.
//
// Protocol (one-sided push, as in the TPU kernels): every rank owns two
// staging slots.  A hop writes its payload into the right neighbour's slot,
// then sets that neighbour's receive flag for (slot, block).  The receiver
// spins on the flag, consumes the slot, and stores a credit that its left
// neighbour reads before it overwrites the same slot two hops later.
//
// Flags and credits are never reset: each holds a tag
//     epoch * TAG_STRIDE + hop + 1,
// where epoch is read from a counter that the wrapper keeps on the device
// and advances after every launch.  Tags of a later call are larger than
// any tag of an earlier one, so a waiter compares with >= and a stale
// value can never satisfy it.
//
// Memory ordering: the payload is written by all threads of the block,
// then __syncthreads(), then thread 0 issues __threadfence() and a
// release store of the flag.  The waiter's thread 0 spins on an acquire
// load, then __syncthreads(); staged data is read with ld.global.cg so no
// stale L1 line from the previous use of the slot is seen.  All buffers
// are plain pointers, so a peer card's buffers could be passed the same
// way (with .sys-scope flags); this version runs every rank on one card.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define ODC_MAX_RANKS 16
#define ODC_THREADS 256
#define ODC_TAG_STRIDE 64u  // > hops of any ring (n <= ODC_MAX_RANKS)
// A waiter that sees no progress for this long traps instead of hanging
// (a co-resident launch never waits this long; only a bug could).
#define ODC_TIMEOUT_NS 30000000000ull

struct OdcArgs {
  const void* in[ODC_MAX_RANKS];   // gather: shard; scatter: contribution
  void* out[ODC_MAX_RANKS];        // gather: (n, c); scatter: (c)
  void* stage[ODC_MAX_RANKS];      // two slots of slot_bytes each
  int order[ODC_MAX_RANKS];        // ring position -> rank
  int pos[ODC_MAX_RANKS];          // rank -> ring position
  int n;                           // ranks on the ring
  long long elems;                 // elements per shard / chunk (c)
  long long slot_bytes;            // bytes of one staging slot (c * elem)
  long long per_block;             // elements of c that one block owns
  unsigned* flags;                 // [n][2][blocks] receive flags
  unsigned* credits;               // [n][blocks] slot-release credits
  const unsigned long long* epoch; // device counter, advanced per call
};

__device__ __forceinline__ unsigned odc_ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void odc_st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long odc_now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Thread 0 waits until *p >= want, then the whole block proceeds.
__device__ __forceinline__ void odc_wait(const unsigned* p, unsigned want) {
  if (threadIdx.x == 0) {
    unsigned long long t0 = 0;
    while (odc_ld_acquire(p) < want) {
      if (t0 == 0) t0 = odc_now_ns();
      else if (odc_now_ns() - t0 > ODC_TIMEOUT_NS) __trap();
      __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// All writes of the block before this call become visible before *p = v.
__device__ __forceinline__ void odc_signal(unsigned* p, unsigned v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    odc_st_release(p, v);
  }
}

__device__ __forceinline__ unsigned odc_tag(unsigned long long epoch,
                                            int hop) {
  return (unsigned)(epoch * ODC_TAG_STRIDE) + (unsigned)hop + 1u;
}

__device__ __forceinline__ bool odc_aligned16(const void* a, const void* b,
                                              const void* c) {
  return ((((uintptr_t)a) | ((uintptr_t)b) | ((uintptr_t)c)) & 15u) == 0;
}

// The element range [lo, hi) of c that this block owns.
__device__ __forceinline__ void odc_slice(const OdcArgs& a, long long* lo,
                                          long long* hi) {
  long long l = (long long)blockIdx.x * a.per_block;
  long long h = l + a.per_block;
  *lo = l < a.elems ? l : a.elems;
  *hi = h < a.elems ? h : a.elems;
}

// The argument block of one launch (host side).
static inline OdcArgs odc_args(const void* const* in, void* const* out,
                        void* const* stage, const int* order, int n,
                        long long elems, int elem_bytes, int blocks,
                        unsigned* flags, unsigned* credits,
                        const unsigned long long* epoch) {
  OdcArgs a = {};
  for (int i = 0; i < n; ++i) {
    a.in[i] = in[i];
    a.out[i] = out[i];
    a.stage[i] = stage[i];
    a.order[i] = order[i];
    a.pos[order[i]] = i;
  }
  a.n = n;
  a.elems = elems;
  a.slot_bytes = elems * elem_bytes;
  // 8 elements per step keeps every slice start 16-byte aligned
  long long per = (elems + blocks - 1) / blocks;
  a.per_block = ((per + 7) / 8) * 8;
  a.flags = flags;
  a.credits = credits;
  a.epoch = epoch;
  return a;
}
