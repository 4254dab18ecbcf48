// ODC scatter-accumulate, single leaf: every owner pulls its chunk from
// every rank's contribution and sums it in registers, in one launch for
// all ranks.
//
// Replaces the TPU kernel repro.kernels.odc_scatter.
// odc_scatter_accumulate_pallas (src/repro/kernels/odc_scatter.py:79,
// _scatter_kernel at :33): there a partial sum travels the ring, and each
// rank adds its own contribution to the chunk that just arrived (the
// owner-side accumulate that stands in for the paper's polling daemon).
// After n-1 hops rank r holds chunk r summed over all ranks.
//
// Why no ring here: every rank of this version lies on one card, so rank
// o's chunk of every rank's contribution is already addressable through
// the pointer table.  A ring's hops would only write each partial sum to
// device memory and read it back at the next hop (the previous version
// moved about (3n - 1) * c bytes a rank against the bound's (n + 1) * c),
// and make every block wait on flags for its neighbour, so that every
// block had to be resident at once.  The owner instead reads the n
// contributions to its chunk directly: the paper's on-demand
// point-to-point pulls in place of a collective.
//
// Order, bitwise the plain ring (repro.core.odc.ring_scatter_accumulate):
// with p the ring position of owner o and at(q) the rank at position
// q mod n,
//     acc = y_at(p+1)[o], then acc = acc + y_at(p+t)[o] for t = 2..n,
// each add in the input type (float32, or bfloat16 rounded to nearest even
// from the float sum, as odc_add4).  This is the order in which the ring's
// partial sum meets the contributions on its way to o.
//
// Grid (blocks_per_rank, n): block (b, o) walks owner o's chunk in
// 16-byte vectors, grid-stride over the b blocks.  A thread keeps
// ODC_PULL_UNROLL vectors of ODC_PULL_GROUP contributors in flight at once
// (16 independent loads for n >= 8), then adds them in order; unrolled
// loads in registers rather than a cp.async.bulk ring in shared memory,
// since every byte is used once by the thread that loads it and nothing
// is shared within the block, so shared memory would only add a copy and
// a barrier.  Every byte is touched once: loads go through the read-only
// path (ld.global.nc, __ldg) and stores carry the streaming hint (__stcs).
// (__ldcs loads, and ld.global.nc.L1::no_allocate ones, measured slower on
// the H100: PERF.md.)  Elements before the first 16-byte boundary of the
// output and after the last whole vector take a scalar path in the same
// kernel; contributions whose chunks are aligned unlike the output take it
// throughout.  No block waits for another: no flags,
// no staging, no residency rule; the grid is any size (the wrapper's
// default: two waves of the blocks the card holds at once).
//
// Bound on one H100 SXM (3.35 TB/s HBM3): with c bytes per chunk and n
// ranks on the card, every contribution is read once (n * n * c) and every
// chunk written once (n * c): (n^2 + n) * c / 3.35e12 s, which is the
// traffic this kernel makes.
//
// Across cards (ROADMAP queue 1 item 9): a contribution on a peer card is
// read the same way through a peer pointer (cudaIpc or a peer-mapped
// allocation) over NVLink, so the table simply holds that pointer; the
// reads become remote and the sum and its order stay as they are.
#include <cuda_bf16.h>

#include "odc_ring.cuh"

__device__ __forceinline__ float4 odc_add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ uint4 odc_add4(uint4 a, uint4 b) {  // 8 x bf16
  uint4 r;
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  __nv_bfloat162* z = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    z[i] = __floats2bfloat162_rn(fx.x + fy.x, fx.y + fy.y);
  }
  return r;
}

__device__ __forceinline__ float odc_add1(float a, float b) { return a + b; }

__device__ __forceinline__ __nv_bfloat16 odc_add1(__nv_bfloat16 a,
                                                  __nv_bfloat16 b) {
  return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
}

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<__nv_bfloat16> { using type = uint4; };

#define ODC_PULL_THREADS 256
#define ODC_PULL_UNROLL 2  // vectors of each contributor a thread holds
#define ODC_PULL_GROUP 8   // contributors loaded before they are added

struct OdcPullArgs {
  const void* in[ODC_MAX_RANKS];  // rank r's contribution, (n, c)
  void* out[ODC_MAX_RANKS];       // rank r's sum, (c)
  int order[ODC_MAX_RANKS];       // ring position -> rank
  int pos[ODC_MAX_RANKS];         // rank -> ring position
  int n;
  long long elems;                // c
};

template <typename T>
__global__ void __launch_bounds__(ODC_PULL_THREADS)
odc_scatter_pull_kernel(const __grid_constant__ OdcPullArgs a) {
  using V = typename Vec16<T>::type;
  constexpr int W = 16 / sizeof(T);
  constexpr int U = ODC_PULL_UNROLL, G = ODC_PULL_GROUP;
  const int n = a.n, o = blockIdx.y;
  const long long c = a.elems;
  // src[t]: chunk o of the contribution added at step t of the ring order
  __shared__ const T* src[ODC_MAX_RANKS];
  if (threadIdx.x < n) {
    const int rank = a.order[(a.pos[o] + 1 + threadIdx.x) % n];
    src[threadIdx.x] = static_cast<const T*>(a.in[rank]) + (long long)o * c;
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out[o]);

  // [0, head) and [tail, c) are scalar; [head, tail) whole vectors
  long long head = (long long)((16 - ((uintptr_t)out & 15)) & 15) / sizeof(T);
  if (head > c) head = c;
  bool vec = true;
  for (int t = 0; t < n; ++t)
    vec &= (((uintptr_t)(src[t] + head)) & 15) == 0;
  if (!vec) head = c;
  const long long nv = (c - head) / W, tail = head + nv * W;

  const long long step = (long long)gridDim.x * ODC_PULL_THREADS * U;
  V* ov = reinterpret_cast<V*>(out + head);
  for (long long base = (long long)blockIdx.x * ODC_PULL_THREADS * U +
                        threadIdx.x;
       base < nv; base += step) {
    V acc[U];
    for (int g0 = 0; g0 < n; g0 += G) {
      V v[G][U];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (g0 + j >= n) break;
        const V* s = reinterpret_cast<const V*>(src[g0 + j] + head);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long i = base + (long long)u * ODC_PULL_THREADS;
          if (i < nv) v[j][u] = __ldg(s + i);
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (g0 + j >= n) break;
#pragma unroll
        for (int u = 0; u < U; ++u)
          acc[u] = (g0 + j == 0) ? v[j][u] : odc_add4(acc[u], v[j][u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + (long long)u * ODC_PULL_THREADS;
      if (i < nv) __stcs(ov + i, acc[u]);
    }
  }

  // the scalar elements: the head, then the tail
  const long long ns = head + (c - tail);
  for (long long e = (long long)blockIdx.x * ODC_PULL_THREADS + threadIdx.x;
       e < ns; e += (long long)gridDim.x * ODC_PULL_THREADS) {
    const long long i = e < head ? e : tail + (e - head);
    T acc = src[0][i];
    for (int t = 1; t < n; ++t) acc = odc_add1(acc, src[t][i]);
    out[i] = acc;
  }
}

static const void* odc_scatter_fn(int dtype) {
  return dtype == 0 ? (const void*)odc_scatter_pull_kernel<float>
                    : (const void*)odc_scatter_pull_kernel<__nv_bfloat16>;
}

// Blocks of the pull kernel the card holds at once (dtype: 0 = float32,
// 1 = bfloat16), from which the wrapper sizes the default grid.
extern "C" int repro_odc_scatter_capacity(int dtype, int* blocks) {
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, odc_scatter_fn(dtype), ODC_PULL_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  *blocks = per_sm * sms;
  return 0;
}

// in, out: host arrays of n device pointers (rank r's (n, c) contribution
// and its (c) sum); order: ring position -> rank.  Returns a CUDA error
// code (0 on success; cudaErrorInvalidValue for arguments it does not
// take).
extern "C" int repro_odc_scatter(const void* const* in, void* const* out,
                                 const int* order, int n, long long elems,
                                 int dtype, int blocks_per_rank,
                                 void* stream) {
  if (n < 1 || n > ODC_MAX_RANKS || blocks_per_rank < 1 || elems < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  OdcPullArgs a = {};
  for (int i = 0; i < n; ++i) {
    a.in[i] = in[i];
    a.out[i] = out[i];
    a.order[i] = order[i];
    a.pos[order[i]] = i;
  }
  a.n = n;
  a.elems = elems;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(blocks_per_rank, n);
  if (dtype == 0)
    odc_scatter_pull_kernel<float><<<grid, ODC_PULL_THREADS, 0, st>>>(a);
  else
    odc_scatter_pull_kernel<__nv_bfloat16>
        <<<grid, ODC_PULL_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Chained scatter-accumulate: L rings in one launch, as a cluster kernel
// whose hops go through distributed shared memory.
//
// Replaces the TPU kernel repro.kernels.odc_scatter.
// odc_scatter_accumulate_layers_pallas (src/repro/kernels/odc_scatter.py:164,
// _scatter_layers_kernel at :113): rank r's stacked (L, n, c)
// contributions -> its (L, c) owned sums, the rings of consecutive layers
// chained in one launch.  The TPU kernel's hop is a remote DMA of the
// partial sum into the right neighbour's VMEM staging slot, signalled by a
// DMA semaphore; here it is a bulk copy into the right neighbour's
// shared-memory slot, signalled by that slot's mbarrier (protocol:
// odc_cluster.cuh).  Each layer starts its partial sum afresh from the
// rank's own contribution and adds in the reference's hop order
// (repro.core.odc.ring_scatter_accumulate), so every layer is bitwise
// equal to the plain ring.
//
// Per layer and tile, rank r's n contribution tiles own(1..n) (own(h) is
// its part of the chunk of rank order[(pos - h) mod n]), and with
// `accumulate` the output tile, come into shared memory by TMA bulk loads:
// own(1) into a first slot (warp 0), the others into own slots (warp 1),
// each up to its ring's slots ahead.  Hop 1 pushes own(1) as it is into
// the right neighbour's recv slot of hop 2 (warp 2).  At hop h (2..n)
// warp 3 adds, on 16-byte vectors, acc = arrived + own(h) in the input
// type (float32, or bfloat16 rounded to nearest even from the float sum,
// as odc_accumulate_cg) into own(h)'s slot, where `arrived` is the partial
// that the left neighbour pushed into the recv slot of hop h; at hop n,
// which completes the rank's own chunk, with `accumulate`, out = out + acc
// in the output type.  Warp 4 then pushes the slot on (before the last
// hop) or bulk-stores it to out (at hop n).  One lane of warps 0-2 and 4
// issues its stream, so that no stream waits for another, not even inside
// a warp.  Partial sums never touch device memory.  Slot release: a first
// or own slot is free once the right neighbour has seen its push land, or
// once its store has read it; a recv slot once the adds have read it, with
// an arrival on the left neighbour's rfree barrier.  Rows that are not
// 16-byte aligned in device memory are copied between device and shared
// memory by the issuing threads instead; the hops stay bulk copies.
//
// `reverse` walks the layers from L - 1 down to 0, the order in which a
// backward pass produces them, over the same (L, n, c) layout.  `ready`
// (L words, may be null): before layer l's first load, each loading
// thread waits until ready[l] has reached `ready_want` (odc_wait_cyclic1);
// the compute stream
// writes it with cuStreamWriteValue32 once layer l's cotangents are in
// place, and that write's default memory barrier makes them visible
// first.  A proxy fence follows the wait, since the compute stream wrote
// the contributions through the generic proxy and TMA reads them through
// the async proxy.
//
// Bound on one H100 SXM (3.35 TB/s HBM3): device memory sees every
// contribution read once (n^2 * c) and every chunk written once (n * c),
// per layer: (n^2 + n) * c * L bytes (plus n * c * L read when
// accumulating).
#include "odc_cluster.cuh"

// warps: two loads, the hop-1 pushes, the adds, the pushes and stores of
// the sums
#define ODC_SCATTER_ADDERS 32
#define ODC_SCATTER_CHAIN_THREADS 160

// own = [extra +] ([arrived +] own) over ne elements of shared memory, by
// the 32 lanes of a warp; `arrived` and `extra` may be null.
template <typename T>
__device__ __forceinline__ void odc_add_tile(T* own, const T* arrived,
                                             const T* extra, int ne,
                                             int lane) {
  using V = typename Vec16<T>::type;
  constexpr int W = 16 / sizeof(T);
  const int nv = ne / W;
  V* o = reinterpret_cast<V*>(own);
  const V* s = reinterpret_cast<const V*>(arrived);
  const V* x = reinterpret_cast<const V*>(extra);
  for (int i = lane; i < nv; i += ODC_SCATTER_ADDERS) {
    V v = o[i];
    if (arrived) v = odc_add4(s[i], v);
    if (extra) v = odc_add4(x[i], v);
    o[i] = v;
  }
  for (int i = nv * W + lane; i < ne; i += ODC_SCATTER_ADDERS) {
    T v = own[i];
    if (arrived) v = odc_add1(arrived[i], v);
    if (extra) v = odc_add1(extra[i], v);
    own[i] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(ODC_SCATTER_CHAIN_THREADS, 8)
odc_scatter_layers_kernel(const __grid_constant__ ChainArgs a, int reverse,
                          int accumulate, const unsigned* ready,
                          unsigned ready_want) {
  extern __shared__ __align__(128) unsigned char odc_smem[];
  const ChainSmem s = odc_chain_smem(odc_smem, a);
  const int n = a.n;
  const int r = blockIdx.y;  // the cluster rank: cluster dims (1, n, 1)
  const int p = a.pos[r];
  const int right = a.order[(p + 1) % n];
  const int left = a.order[(p + n - 1) % n];
  const ChainSlice g = odc_chain_slice(a);
  const int es = (int)sizeof(T), tb = a.tile_bytes;
  const int S = a.own_slots, F = a.first_slots, D = a.recv_depth;
  const long long c = a.elems;
  // own-ring items per (layer, tile): own(h0..n), then the output tile
  const int h0 = n > 1 ? 2 : 1;
  const int NM = n - h0 + 1 + (accumulate ? 1 : 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  odc_chain_init(s, a, 1, 1, 1);

  const T* y = static_cast<const T*>(a.in[r]);
  T* out = static_cast<T*>(a.out[r]);
  OdcPending pend{0, 0};
  // one load into a slot of this block, completing on `full`
  auto load = [&](T* slot, const T* src, long long ne, uint64_t* full) {
    if (a.aligned) {
      odc_arrive_expect(full, (uint32_t)(ne * es));
      odc_bulk_load(slot, src, (uint32_t)(ne * es), full);
    } else {
      odc_copy_elems(slot, src, ne, es);
      odc_fence_async_smem();
      odc_arrive_local(full);
    }
  };
  // into the right neighbour's recv slot of hop h of tile k (one thread
  // writes each hop's slots: warp 2 hop 2, warp 4 the others)
  auto push = [&](const T* src, long long k, int h, uint32_t bytes) {
    const int q = odc_recv_slot(a, k, h - 1);
    const long long v = k / D;
    if (v > 0) odc_bar_wait(s.rfree + q, (uint32_t)((v - 1) & 1), &pend);
    odc_bulk_push(odc_mapa(odc_smem_u32(s.recv + (long long)q * tb), right),
                  src, bytes, odc_mapa(odc_smem_u32(s.full_recv + q), right));
  };
  auto own_src = [&](int l, int h, long long e0) {
    return y + ((long long)l * n + a.order[(p - h % n + n) % n]) * c + e0;
  };

  if (warp != 3 && (lane != 0 || (n == 1 && (warp == 0 || warp == 2)))) {
    // idle: lane 0 of each warp but the adds' issues its stream alone
  } else if (warp < 2) {
    // the loads: warp 0 own(1) into the first ring, warp 1 the rest into
    // the own ring, in the adders' order
    for (int kl = 0; kl < a.layers; ++kl) {
      const int l = reverse ? a.layers - 1 - kl : kl;
      if (ready != nullptr) {
        odc_wait_cyclic1(ready + l, ready_want);
        odc_fence_async();
      }
      for (int t = 0; t < g.tiles; ++t) {
        const long long k = (long long)kl * g.tiles + t;
        const long long e0 = g.lo + t * g.te;
        const long long ne = min(g.te, g.hi - e0);
        if (warp == 0) {
          const int o = (int)(k % F);
          if (k >= F)
            odc_bar_wait(s.empty_first + o, (uint32_t)((k / F - 1) & 1));
          load(reinterpret_cast<T*>(s.first + (long long)o * tb),
               own_src(l, 1, e0), ne, s.full_first + o);
          continue;
        }
        for (int m = 0; m < NM; ++m) {
          const long long i = k * NM + m;
          const int o = (int)(i % S);
          if (i >= S)
            odc_bar_wait(s.empty_own + o, (uint32_t)((i / S - 1) & 1));
          const int h = h0 + m;
          load(reinterpret_cast<T*>(s.own + (long long)o * tb),
               h <= n ? own_src(l, h, e0) : out + (long long)l * c + e0, ne,
               s.full_own + o);
        }
      }
    }
  } else if (warp == 2) {
    // hop 1: own(1) as it is, into the right neighbour's slot of hop 2
    for (long long k = 0; k < (long long)a.layers * g.tiles; ++k) {
      const int o = (int)(k % F);
      const long long ne = min(g.te, g.hi - (g.lo + (k % g.tiles) * g.te));
      odc_bar_wait(s.full_first + o, (uint32_t)((k / F) & 1));
      push(reinterpret_cast<const T*>(s.first + (long long)o * tb), k, 2,
           odc_push_bytes(ne * es));
    }
  } else if (warp == 3) {
    // the adds, all 32 lanes: own(h) = [out +] arrived + own(h) in place
    for (int kl = 0; kl < a.layers; ++kl) {
      for (int t = 0; t < g.tiles; ++t) {
        const long long k = (long long)kl * g.tiles + t;
        const long long ne = min(g.te, g.hi - (g.lo + t * g.te));
        const uint32_t pb = odc_push_bytes(ne * es);
        for (int h = h0; h <= n; ++h) {
          const long long i = k * NM + h - h0;
          const int o = (int)(i % S);
          const T* arrived = nullptr;
          int q = 0;
          if (h >= 2) {  // first, so that the left's slot is freed soonest
            q = odc_recv_slot(a, k, h - 1);
            if (lane == 0) odc_arrive_expect(s.full_recv + q, pb);
            odc_bar_wait(s.full_recv + q, (uint32_t)((k / D) & 1));
            if (lane == 0) {  // the push landed: its source slot is free
              const uint32_t src =
                  h == 2 ? odc_smem_u32(s.empty_first + (int)(k % F))
                         : odc_smem_u32(s.empty_own + (int)((i - 1) % S));
              odc_arrive_cluster(odc_mapa(src, left), 1);
            }
            arrived = reinterpret_cast<const T*>(s.recv + (long long)q * tb);
          }
          odc_bar_wait(s.full_own + o, (uint32_t)((i / S) & 1));
          const T* extra = nullptr;
          int oo = 0;
          if (h == n && accumulate) {
            const long long io = i + 1;
            oo = (int)(io % S);
            odc_bar_wait(s.full_own + oo, (uint32_t)((io / S) & 1));
            extra = reinterpret_cast<const T*>(s.own + (long long)oo * tb);
          }
          odc_add_tile<T>(reinterpret_cast<T*>(s.own + (long long)o * tb),
                          arrived, extra, (int)ne, lane);
          odc_fence_async_smem();
          __syncwarp();
          if (lane == 0) {
            if (h >= 2)  // the recv slot is read: the left may write it
              odc_arrive_cluster(odc_mapa(odc_smem_u32(s.rfree + q), left),
                                 1);
            odc_arrive_local(s.computed + o);
            if (extra != nullptr) odc_arrive_local(s.computed + oo);
          }
        }
      }
    }
  } else if (warp == 4 && lane == 0) {
    // the sums: pushed on before the last hop, stored at it
    for (int kl = 0; kl < a.layers; ++kl) {
      const int l = reverse ? a.layers - 1 - kl : kl;
      for (int t = 0; t < g.tiles; ++t) {
        const long long k = (long long)kl * g.tiles + t;
        const long long e0 = g.lo + t * g.te;
        const long long ne = min(g.te, g.hi - e0);
        for (int m = 0; m < NM; ++m) {
          const long long i = k * NM + m;
          const int o = (int)(i % S);
          const int h = h0 + m;
          T* slot = reinterpret_cast<T*>(s.own + (long long)o * tb);
          odc_bar_wait(s.computed + o, (uint32_t)((i / S) & 1), &pend);
          if (h > n) {  // the output tile, read by the adds
            odc_arrive_local(s.empty_own + o);
          } else if (h < n) {
            push(slot, k, h + 1, odc_push_bytes(ne * es));
          } else {  // my chunk, summed over every rank
            T* dst = out + (long long)l * c + e0;
            const uint32_t bar = odc_mapa(odc_smem_u32(s.empty_own + o), r);
            if (a.aligned) {
              odc_bulk_store(dst, slot, (uint32_t)(ne * es));
              odc_pending_add(pend, bar, 1);
            } else {
              odc_copy_elems(dst, slot, ne, es);
              odc_arrive_cluster(bar, 1);
            }
          }
        }
      }
    }
    odc_pending_flush(pend);
    odc_bulk_wait_all();
  }
  __syncthreads();
  odc_cluster_sync();
}

static const void* odc_scatter_layers_fn(int dtype) {
  return dtype == 0 ? (const void*)odc_scatter_layers_kernel<float>
                    : (const void*)odc_scatter_layers_kernel<__nv_bfloat16>;
}

// dtype: 0 = float32, 1 = bfloat16
extern "C" int repro_odc_scatter_layers_capacity(int dtype, int n, int smem,
                                                 int* clusters) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return odc_chain_capacity(odc_scatter_layers_fn(dtype), n,
                            ODC_SCATTER_CHAIN_THREADS, smem, clusters);
}

// Returns a CUDA error code (0 on success); refuses, without launching, a
// grid of more clusters than the card can hold at once
// (cudaErrorCooperativeLaunchTooLarge).  `elems` is c, the elements of one
// layer's owned chunk; `slice`, `tile_bytes`, the slot counts and
// `blocks_per_rank` are the wrapper's launch plan (_ring.chain_plan).
extern "C" int repro_odc_scatter_layers(const void* const* in,
                                        void* const* out, const int* order,
                                        int n, long long elems, int dtype,
                                        int layers, long long slice,
                                        int tile_bytes, int own_slots,
                                        int first_slots, int recv_depth,
                                        int blocks_per_rank, int reverse,
                                        int accumulate, const unsigned* ready,
                                        unsigned ready_want, void* stream) {
  ChainArgs a;
  if (blocks_per_rank < 1 || (dtype != 0 && dtype != 1) ||
      (n > 1 && first_slots < 1) ||
      !odc_chain_args(&a, in, out, order, n, layers, elems,
                      dtype == 0 ? 4 : 2, slice, tile_bytes, own_slots,
                      first_slots, recv_depth))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)odc_chain_smem_bytes(n, tile_bytes, own_slots,
                                             first_slots, recv_depth);
  int clusters;
  int e = repro_odc_scatter_layers_capacity(dtype, n, smem, &clusters);
  if (e != 0) return e;
  if (blocks_per_rank > clusters)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  odc_chain_config(&cfg, &attr, blocks_per_rank, n,
                   ODC_SCATTER_CHAIN_THREADS, smem,
                   static_cast<cudaStream_t>(stream));
  void* params[] = {&a, &reverse, &accumulate, &ready, &ready_want};
  cudaError_t err = cudaLaunchKernelExC(&cfg, odc_scatter_layers_fn(dtype),
                                        params);
  cudaError_t last = cudaGetLastError();  // clears a launch error
  return (int)(err != cudaSuccess ? err : last);
}
