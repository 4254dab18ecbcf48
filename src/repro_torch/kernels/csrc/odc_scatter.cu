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
