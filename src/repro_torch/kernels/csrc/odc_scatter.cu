// ODC scatter-accumulate: the ring reduce-scatter of gradient
// contributions as one-sided pushes of partial sums, every rank of the ring
// on this card, in one cooperative launch.
//
// Replaces the TPU kernel repro.kernels.odc_scatter.
// odc_scatter_accumulate_pallas (src/repro/kernels/odc_scatter.py:79,
// _scatter_kernel at :33): a partial sum travels the ring, and each rank
// adds its own contribution to the chunk that just arrived (the owner-side
// accumulate that stands in for the paper's polling daemon).  After n-1
// hops rank r holds chunk r summed over all ranks.  Protocol: odc_ring.cuh.
//
// Grid (blocks_per_rank, n): block (b, r) carries slice b of the chunk
// through every hop.  Rank r's input is (n, c), its output (c).  At hop h
// (1-based) rank r sends the partial of chunk order[(pos - h) mod n]; each
// hop computes acc = arrived + own in the input type (float32, or bfloat16
// rounded to nearest even from the float sum), in the reference's order
// (repro.core.odc.ring_scatter_accumulate), so the result is bitwise equal
// to the plain ring.
//
// Bound on one H100 SXM (3.35 TB/s HBM3): with c bytes per chunk and n
// ranks on the card, the least traffic is n*n*c read (every rank's full
// contribution once) plus n*c written (every rank's chunk):
// (n^2 + n) * c / 3.35e12 s.  What this simple design leaves on the table:
// every partial sum is written to a staging slot and read back at the next
// hop (2*(n-1)*c more traffic per rank), and a block that waits for its left
// neighbour spins instead of doing other work.
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

// dst[i] = arrived[i] + own[i] for i < n; `arrived` is null for a plain
// copy of `own` (the first hop), else a staging slot read through L2.
template <typename T>
__device__ __forceinline__ void odc_accumulate(T* dst, const T* arrived,
                                               const T* own, long long n) {
  using V = typename Vec16<T>::type;
  constexpr int W = 16 / sizeof(T);
  long long done = 0;
  if (odc_aligned16(dst, arrived, own)) {
    const long long nv = n / W;
    V* d = reinterpret_cast<V*>(dst);
    const V* o = reinterpret_cast<const V*>(own);
    const V* s = reinterpret_cast<const V*>(arrived);
    for (long long i = threadIdx.x; i < nv; i += blockDim.x) {
      V v = o[i];
      if (arrived) v = odc_add4(__ldcg(s + i), v);
      __stcg(d + i, v);
    }
    done = nv * W;
  }
  for (long long i = done + threadIdx.x; i < n; i += blockDim.x) {
    T v = own[i];
    if (arrived) v = odc_add1(__ldcg(arrived + i), v);
    dst[i] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(ODC_THREADS)
odc_scatter_kernel(const __grid_constant__ OdcArgs a) {
  const int n = a.n;
  const int r = blockIdx.y;
  const int p = a.pos[r];
  const int right = a.order[(p + 1) % n];
  const int B = gridDim.x, b = blockIdx.x;
  const unsigned long long epoch = *a.epoch;
  long long lo, hi;
  odc_slice(a, &lo, &hi);
  const long long len = hi - lo, c = a.elems;

  const T* y = static_cast<const T*>(a.in[r]);
  T* out = static_cast<T*>(a.out[r]);
  T* mine = static_cast<T*>(a.stage[r]);
  T* theirs = static_cast<T*>(a.stage[right]);
  unsigned* my_flags = a.flags + (size_t)r * 2 * B;
  unsigned* their_flags = a.flags + (size_t)right * 2 * B;
  // my contribution to the chunk owned `off` ring positions behind me
  auto own = [&](int off) {
    return y + (long long)a.order[((p - off) % n + n) % n] * c + lo;
  };

  if (n == 1) {
    odc_accumulate<T>(out + lo, nullptr, own(0), len);
    return;
  }
  // hop 1: my contribution to my left neighbour's chunk, as it is
  odc_accumulate<T>(theirs + (long long)1 * c + lo, nullptr, own(1), len);
  odc_signal(their_flags + (size_t)1 * B + b, odc_tag(epoch, 1));
  for (int h = 2; h < n; ++h) {
    const int in_slot = (h - 1) & 1, out_slot = h & 1;
    odc_wait(my_flags + (size_t)in_slot * B + b, odc_tag(epoch, h - 1));
    // the right neighbour must have consumed hop h - 2 from this slot
    if (h >= 3) odc_wait(a.credits + (size_t)right * B + b,
                         odc_tag(epoch, h - 2));
    odc_accumulate<T>(theirs + (long long)out_slot * c + lo,
                      mine + (long long)in_slot * c + lo, own(h), len);
    odc_signal(their_flags + (size_t)out_slot * B + b, odc_tag(epoch, h));
    odc_signal(a.credits + (size_t)r * B + b, odc_tag(epoch, h - 1));
  }
  // the last hop brings my own chunk, summed over every other rank
  const int last = (n - 1) & 1;
  odc_wait(my_flags + (size_t)last * B + b, odc_tag(epoch, n - 1));
  odc_accumulate<T>(out + lo, mine + (long long)last * c + lo, own(n), len);
}

static const void* odc_scatter_fn(int dtype) {
  return dtype == 0 ? (const void*)odc_scatter_kernel<float>
                    : (const void*)odc_scatter_kernel<__nv_bfloat16>;
}

// dtype: 0 = float32, 1 = bfloat16
extern "C" int repro_odc_scatter_capacity(int dtype, int* blocks) {
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, odc_scatter_fn(dtype), ODC_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  *blocks = per_sm * sms;
  return 0;
}

// Returns a CUDA error code (0 on success); refuses, without launching, a
// grid whose blocks cannot all be resident at once.
extern "C" int repro_odc_scatter(const void* const* in, void* const* out,
                                 void* const* stage, const int* order, int n,
                                 long long elems, int dtype,
                                 int blocks_per_rank, unsigned* flags,
                                 unsigned* credits,
                                 const unsigned long long* epoch,
                                 void* stream) {
  if (n < 1 || n > ODC_MAX_RANKS || blocks_per_rank < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  int cap;
  int e = repro_odc_scatter_capacity(dtype, &cap);
  if (e != 0) return e;
  if ((long long)n * blocks_per_rank > cap)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  OdcArgs a = odc_args(in, out, stage, order, n, elems, dtype == 0 ? 4 : 2,
                       blocks_per_rank, flags, credits, epoch);
  void* params[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      odc_scatter_fn(dtype), dim3(blocks_per_rank, n), dim3(ODC_THREADS),
      params, 0, static_cast<cudaStream_t>(stream));
  cudaError_t last = cudaGetLastError();  // clears a launch error
  return (int)(err != cudaSuccess ? err : last);
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
