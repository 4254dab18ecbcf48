// Shared pieces of the chained ODC ring kernels (odc_gather_layers_kernel,
// odc_scatter_layers_kernel): thread block clusters whose hops go through
// distributed shared memory.
//
// Layout.  Grid (blocks_per_rank, n), cluster dims (1, n, 1): cluster b is
// slice b of every layer's c for all n ranks, and block (b, r) -- cluster
// rank r -- is rank r's worker for that slice.  A slice is cut into tiles
// of tile_bytes; every block of a cluster walks the same sequence of
// (layer, tile, hop) items, so an item's slot index and barrier phase are
// the same arithmetic on the sending and the receiving side.
//
// Streams.  Each block holds rings of tile slots in dynamic shared memory:
// `own` (tiles loaded from device memory by TMA bulk loads), for the
// scatter also `first` (the tiles its hop 1 pushes as they are), and
// `recv` (tiles pushed in by the left neighbour).  The recv ring gives
// every hop h its own recv_depth slots: slot (k % depth) * (n - 1) + h - 1
// holds hop h of tile k.  So each ring slot carries one stream -- the own
// tiles, or one hop -- and one thread issues that stream in tile order:
// hop h of tile k + 1 never waits for hop h + 1 of tile k, and every
// thread waits for every phase of the barriers it waits on, in order.
//
// Barriers.  Every slot has a *full* mbarrier (one arrive with expect_tx
// by the block itself, plus the bytes that land) and a barrier that tells
// the slot's writer that it may write the slot again: *empty* for an own
// or first slot (the block writes it itself), *rfree* for a recv slot (it
// lives in the left neighbour, the writer, and is arrived on remotely).
// A hop pushes a tile from the sender's shared memory into the right
// neighbour's recv slot with cp.async.bulk.shared::cluster.shared::cta,
// completing on the neighbour's full barrier (its mapa address); the
// receiver, once that barrier has flipped, arrives on the sender's
// barrier of the source slot (the ack).  Barrier phases replace the flags
// and tags of odc_ring.cuh: the u-th use of a slot waits for phase u & 1,
// and nothing persists between launches.
//
// Residency.  The hardware co-schedules a cluster's blocks, and every wait
// of a chained kernel is on a barrier inside the cluster (or, for the
// scatter, on a ready word that the compute stream writes), so the launch
// is an ordinary cudaLaunchKernelEx with a cluster dimension, without the
// cooperative launch, flags or tags of the single-leaf rings.  The host
// still refuses a grid larger than cudaOccupancyMaxActiveClusters: the
// scatter's clusters wait for the compute stream, and clusters queued
// behind resident ones could hold that stream's kernels off the card
// until the wait traps.
//
// Exit.  Every block ends with a cluster barrier, so that no block exits
// while a peer may still write into its shared memory or arrive on its
// barriers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "odc_ring.cuh"

struct ChainArgs {
  const void* in[ODC_MAX_RANKS];  // gather: (L, c) shard; scatter: (L, n, c)
  void* out[ODC_MAX_RANKS];       // gather: (L, n, c); scatter: (L, c)
  int order[ODC_MAX_RANKS];       // ring position -> rank
  int pos[ODC_MAX_RANKS];         // rank -> ring position
  int n;                          // ranks on the ring (cluster size)
  int layers;                     // L
  long long elems;                // c, elements of one layer's shard
  long long slice;                // elements of c per cluster
  int elem_bytes;
  int tile_bytes;                 // bytes of one slot (a multiple of 128)
  int own_slots, first_slots;     // first: the scatter's hop-1 tiles
  int recv_depth;                 // recv slots per hop
  int aligned;  // every row in device memory is 16-byte aligned: TMA
};

__host__ __device__ inline int odc_recv_slots(int n, int depth) {
  return n > 1 ? depth * (n - 1) : 0;
}

// A block's shared memory: the slots, then two barriers for each and a
// third for each own slot.
__host__ __device__ inline long long odc_chain_smem_bytes(
    int n, int tile_bytes, int own_slots, int first_slots, int depth) {
  const long long slots = own_slots + first_slots + odc_recv_slots(n, depth);
  return slots * (tile_bytes + 16) + 8ll * own_slots;
}

struct ChainSmem {
  unsigned char* own;    // own_slots x tile_bytes
  unsigned char* first;  // first_slots x tile_bytes
  unsigned char* recv;   // recv_slots x tile_bytes
  uint64_t* full_own;
  uint64_t* empty_own;
  uint64_t* full_first;
  uint64_t* empty_first;
  uint64_t* full_recv;
  uint64_t* rfree;       // the right neighbour's recv slots, free to write
  uint64_t* computed;    // the scatter's adds into an own slot are done
};

__device__ __forceinline__ ChainSmem odc_chain_smem(unsigned char* base,
                                                    const ChainArgs& a) {
  const int R = odc_recv_slots(a.n, a.recv_depth);
  const int S = a.own_slots, F = a.first_slots;
  ChainSmem s;
  s.own = base;
  s.first = s.own + (long long)S * a.tile_bytes;
  s.recv = s.first + (long long)F * a.tile_bytes;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(s.recv + (long long)R * a.tile_bytes);
  s.full_own = bars;
  s.empty_own = s.full_own + S;
  s.full_first = s.empty_own + S;
  s.empty_first = s.full_first + F;
  s.full_recv = s.empty_first + F;
  s.rfree = s.full_recv + R;
  s.computed = s.rfree + R;
  return s;
}

// The recv slot of hop h (1..n-1) of tile k, and its use.
__device__ __forceinline__ int odc_recv_slot(const ChainArgs& a, long long k,
                                             int h) {
  return (int)(k % a.recv_depth) * (a.n - 1) + h - 1;
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t odc_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of `local` (a shared::cta address) in the
// block of cluster rank `rank`.
__device__ __forceinline__ uint32_t odc_mapa(uint32_t local, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(local), "r"(rank));
  return r;
}

__device__ __forceinline__ void odc_bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(odc_smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void odc_cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

// One local arrival that also announces `bytes` to land on the barrier.
__device__ __forceinline__ void odc_arrive_expect(uint64_t* bar,
                                                  uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(odc_smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void odc_arrive_local(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(odc_smem_u32(bar)) : "memory");
}

// `count` arrivals on a barrier given by its shared::cluster address (a
// peer's, or this block's own through mapa).  The default semantics
// (release at CTA scope), as CUTLASS's cluster pipelines arrive: a
// release at cluster scope makes every arrival wait like a fence, which
// throttles the rings.
__device__ __forceinline__ void odc_arrive_cluster(uint32_t bar,
                                                   uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool odc_bar_test(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok) : "r"(odc_smem_u32(bar)), "r"(parity) : "memory");
  return ok != 0;
}

// TMA bulk load: `bytes` from device memory into this block's shared
// memory, completing on `bar` (this block's).
__device__ __forceinline__ void odc_bulk_load(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(odc_smem_u32(dst)), "l"(src), "r"(bytes),
         "r"(odc_smem_u32(bar)) : "memory");
}

// TMA bulk store: `bytes` from this block's shared memory to device memory,
// in the issuing thread's current bulk group.
__device__ __forceinline__ void odc_bulk_store(void* dst, const void* src,
                                               uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(odc_smem_u32(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// A hop: `bytes` from this block's shared memory into a peer's, completing
// on the peer's barrier (both shared::cluster addresses).
__device__ __forceinline__ void odc_bulk_push(uint32_t dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(dst), "r"(odc_smem_u32(src)), "r"(bytes), "r"(bar) : "memory");
}

// This thread's bulk stores have read their shared memory.
__device__ __forceinline__ void odc_bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// This thread's bulk stores are complete in device memory.
__device__ __forceinline__ void odc_bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Generic-proxy writes to shared memory before an async-proxy read of it
// (a bulk push or store), by every thread that wrote.
__device__ __forceinline__ void odc_fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void odc_fence_async() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

// ---------------------------------------------------------------------------
// The store-read arrival a thread that issues bulk stores holds back: a
// slot is free once its store has read it, and waiting for that right
// after the store would keep one store in flight.  So a store's arrival
// is made once the next store is issued (cp.async.bulk.wait_group.read 1),
// or before the thread blocks on any barrier (so that it never holds a
// slot that the wait depends on), or at a layer's end.
// ---------------------------------------------------------------------------
struct OdcPending {
  uint32_t bar, count;  // the arrival held back, if count > 0
};

__device__ __forceinline__ void odc_pending_flush(OdcPending& p) {
  if (p.count == 0) return;
  odc_bulk_wait_read();
  odc_arrive_cluster(p.bar, p.count);
  p.count = 0;
}

// After a bulk store (committed as its own group): free the slot of the
// store before it, hold this one's arrival.
__device__ __forceinline__ void odc_pending_add(OdcPending& p, uint32_t bar,
                                                uint32_t count) {
  if (p.count != 0) {
    asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
    odc_arrive_cluster(p.bar, p.count);
  }
  p.bar = bar;
  p.count = count;
}

// Wait for phase `parity` of a barrier of this block; `p` (may be null) is
// flushed first if the wait would block.  Traps after ODC_TIMEOUT_NS
// without progress.
__device__ __forceinline__ void odc_bar_wait(uint64_t* bar, uint32_t parity,
                                             OdcPending* p = nullptr) {
  if (odc_bar_test(bar, parity)) return;
  if (p != nullptr) odc_pending_flush(*p);
  const unsigned long long t0 = odc_now_ns();
  while (!odc_bar_test(bar, parity))
    if (odc_now_ns() - t0 > ODC_TIMEOUT_NS) __trap();
}

// One thread waits until the 32-bit word at p has reached `want` in cyclic
// order ((int)(*p - want) >= 0, the comparison cuStreamWaitValue32 makes).
// The word is written by another stream (cuStreamWriteValue32), so this
// wait also covers the compute stream: a lockstep microbatch's backward at
// full width takes a few seconds, so the trap still only catches a bug (a
// ready flag that never comes).
__device__ __forceinline__ void odc_wait_cyclic1(const unsigned* p,
                                                 unsigned want) {
  unsigned long long t0 = 0;
  while ((int)(odc_ld_acquire(p) - want) < 0) {
    if (t0 == 0) t0 = odc_now_ns();
    else if (odc_now_ns() - t0 > ODC_TIMEOUT_NS) __trap();
    __nanosleep(256);
  }
}

// Copy `ne` elements of `es` bytes with one thread: the route for rows
// that are not 16-byte aligned in device memory.
__device__ __forceinline__ void odc_copy_elems(void* dst, const void* src,
                                               long long ne, int es) {
  if (es == 4) {
    const uint32_t* s = static_cast<const uint32_t*>(src);
    uint32_t* d = static_cast<uint32_t*>(dst);
    for (long long i = 0; i < ne; ++i) d[i] = s[i];
  } else if (es == 2) {
    const uint16_t* s = static_cast<const uint16_t*>(src);
    uint16_t* d = static_cast<uint16_t*>(dst);
    for (long long i = 0; i < ne; ++i) d[i] = s[i];
  } else {
    const unsigned char* s = static_cast<const unsigned char*>(src);
    unsigned char* d = static_cast<unsigned char*>(dst);
    for (long long i = 0; i < ne * es; ++i) d[i] = s[i];
  }
}

// ---------------------------------------------------------------------------
// Geometry: this cluster's slice of c and its tiles.
// ---------------------------------------------------------------------------
struct ChainSlice {
  long long lo, hi;  // elements [lo, hi) of c
  long long te;      // elements per tile
  int tiles;
};

__device__ __forceinline__ ChainSlice odc_chain_slice(const ChainArgs& a) {
  ChainSlice s;
  long long lo = (long long)blockIdx.x * a.slice;
  long long hi = lo + a.slice;
  s.lo = lo < a.elems ? lo : a.elems;
  s.hi = hi < a.elems ? hi : a.elems;
  s.te = a.tile_bytes / a.elem_bytes;
  s.tiles = (int)((s.hi - s.lo + s.te - 1) / s.te);
  return s;
}

// Bytes a hop moves for a tile of `nb` bytes: bulk copies take multiples
// of 16, and a slot holds a whole multiple (tile_bytes % 128 == 0).
__device__ __forceinline__ uint32_t odc_push_bytes(long long nb) {
  return (uint32_t)((nb + 15) & ~15ll);
}

// Every barrier of the block initialised by thread 0 (full and computed
// barriers take one arrival; the others `empty_count`, `first_count`,
// `rfree_count`),
// made visible to the cluster, and every block of the cluster past its
// initialisation before any remote access.
__device__ __forceinline__ void odc_chain_init(const ChainSmem& s,
                                               const ChainArgs& a,
                                               uint32_t empty_count,
                                               uint32_t first_count,
                                               uint32_t rfree_count) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.own_slots; ++i) {
      odc_bar_init(s.full_own + i, 1);
      odc_bar_init(s.empty_own + i, empty_count);
      odc_bar_init(s.computed + i, 1);
    }
    for (int i = 0; i < a.first_slots; ++i) {
      odc_bar_init(s.full_first + i, 1);
      odc_bar_init(s.empty_first + i, first_count);
    }
    for (int i = 0; i < odc_recv_slots(a.n, a.recv_depth); ++i) {
      odc_bar_init(s.full_recv + i, 1);
      odc_bar_init(s.rfree + i, rfree_count);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  odc_cluster_sync();
}

// One thread's part of a layer's done word: its bulk stores of the layer
// complete in device memory, then visible to the generic proxy and to the
// card, then one more on done[l].
__device__ __forceinline__ void odc_layer_done(unsigned* done, int l,
                                               OdcPending& p) {
  odc_pending_flush(p);
  odc_bulk_wait_all();
  odc_fence_async();
  __threadfence();
  atomicAdd(done + l, 1u);
}

// Host side: the attributes a chained kernel needs before its occupancy is
// queried or it is launched (dynamic shared memory above 48 KB, clusters
// above the portable 8, all of the SM's shared memory as carveout).
static inline cudaError_t odc_chain_attrs(const void* fn, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        fn, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  return e;
}

static inline void odc_chain_config(cudaLaunchConfig_t* cfg,
                                    cudaLaunchAttribute* attr, int blocks,
                                    int n, int threads, int smem,
                                    cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks, n, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = n;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Clusters of n blocks of this kernel that the card can hold at once.
static inline int odc_chain_capacity(const void* fn, int n, int threads,
                                     int smem, int* clusters) {
  if (n < 1 || n > ODC_MAX_RANKS || smem < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = odc_chain_attrs(fn, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  odc_chain_config(&cfg, &attr, 1, n, threads, smem, 0);
  e = cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: a cluster too large is a refusal
    *clusters = 0;
  }
  return 0;
}

// The argument block of one chained launch (host side); false on bad
// input.
static inline bool odc_chain_args(ChainArgs* a, const void* const* in,
                                  void* const* out, const int* order, int n,
                                  int layers, long long elems, int elem_bytes,
                                  long long slice, int tile_bytes,
                                  int own_slots, int first_slots,
                                  int recv_depth) {
  if (n < 1 || n > ODC_MAX_RANKS || layers < 1 || elem_bytes < 1 ||
      slice < 1 || tile_bytes < 128 || tile_bytes % 128 ||
      tile_bytes % elem_bytes || own_slots < 2 || first_slots < 0 ||
      recv_depth < 1)
    return false;
  *a = ChainArgs{};
  bool aligned = (elems * elem_bytes) % 16 == 0 &&
                 (slice * elem_bytes) % 16 == 0;
  for (int i = 0; i < n; ++i) {
    a->in[i] = in[i];
    a->out[i] = out[i];
    a->order[i] = order[i];
    a->pos[order[i]] = i;
    aligned = aligned && ((uintptr_t)in[i] % 16 == 0) &&
              ((uintptr_t)out[i] % 16 == 0);
  }
  a->n = n;
  a->layers = layers;
  a->elems = elems;
  a->slice = slice;
  a->elem_bytes = elem_bytes;
  a->tile_bytes = tile_bytes;
  a->own_slots = own_slots;
  a->first_slots = first_slots;
  a->recv_depth = recv_depth;
  a->aligned = aligned ? 1 : 0;
  return true;
}
