// ODC gather fused with the consumer matmul (collective matmul) for
// Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: src/repro/kernels/gather_matmul.py::gather_matmul_pallas (the
// pallas_call at :92, body _gather_matmul_kernel :27).  Same function
// (ops.gather_matmul), for every rank of a ring at once: rank r holds x_r
// (m, k) and the r-th (c, f) row shard of W (k = n * c); it gets
//   out_r = sum_{i = 0 .. n-1} x_r[:, s_i*c : (s_i+1)*c] @ shard_{s_i},
//   s_i = (r - i) mod n,
// the TPU kernel's hop order (:62-66): on hop i rank r multiplies the
// shard that has travelled i hops to it.  Each hop's product is summed in
// f32 registers and added to the f32 total once per hop; the total is
// rounded to the output type (x's) once, at the end.  The full W never
// exists.
//
// What has no counterpart here: the TPU kernel's two staging slots, its
// DMA semaphores and the credit back-pressure (:36-77) guard a VMEM slot
// that the left neighbour overwrites while this device still multiplies
// it.  Every rank of this version lies on one card, so each shard stays
// where its owner holds it, read-only for the whole call, and each block
// reads shard s_i there through the per-rank pointer table: there is
// nothing in flight to guard.  Across cards, that read is the on-demand
// pull of the peer-pointer route (ROADMAP queue 1 item 9): a block reads
// the owner's shard over NVLink through a peer pointer, with no staging
// copy and no send.
//
// Design.  One launch for every rank: the grid is (f tiles, m tiles,
// ranks).  A block owns a 64 x 64 tile of one rank's output and walks the
// hops in the order above; per hop it walks the shard's c rows in steps
// of kBK = 16: the (64, 16) slice of x and the (16, 64) slice of the
// shard are staged in shared memory as f32 (x transposed, so that a
// thread reads its 4 rows as one float4), and each of the 256 threads
// multiplies a 4 x 4 register tile.  Ragged edges (m, f or c not a
// multiple of the tile) are staged as zeros.
//
// What bounds it on the H100: the operations, 2 m k f per rank.  Every
// product here runs on the CUDA cores in f32 (67 TFLOP/s), bf16 inputs
// included; the bytes (x and the shards read once, the outputs written
// once) are two orders of magnitude below.  What this simple design
// leaves on the table: the tensor cores (wgmma on bf16 or TF32 tiles fed
// by TMA, with a warp-specialised producer), double buffering of the
// staged tiles, vector loads from device memory, and 8 x 8 register tiles
// (a 4 x 4 tile spends 2 shared-memory loads on 16 FMAs a k step).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxRanks = 16;
constexpr int kThreads = 256;
constexpr int kBM = 64;  // output rows of a block
constexpr int kBN = 64;  // output columns of a block
constexpr int kBK = 16;  // shard rows staged at a time

struct Ranks {
  const void* x[kMaxRanks];
  const void* w[kMaxRanks];
  void* out[kMaxRanks];
};

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_matmul_kernel(Ranks ranks, int n, int m, int k, int f) {
  __shared__ __align__(16) float xs[kBK][kBM];  // x slice, transposed
  __shared__ __align__(16) float ws[kBK][kBN];  // shard slice

  const int r = blockIdx.z;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int c = k / n;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // the 4 x 4 tile at (4ty, 4tx)
  const T* x = static_cast<const T*>(ranks.x[r]);

  // staging: x slice 64 rows x 16 columns, 4 consecutive columns a
  // thread; shard slice 16 rows x 64 columns, 4 consecutive columns a
  // thread
  const int xr = tid / 4, xc = (tid % 4) * 4;
  const int wr = tid / 16, wc = (tid % 16) * 4;

  float total[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) total[i][j] = 0.f;

  for (int hop = 0; hop < n; ++hop) {
    const int s = (r - hop + n) % n;  // owner of the shard of this hop
    const T* w = static_cast<const T*>(ranks.w[s]);
    const long long xcol0 = (long long)s * c;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < c; k0 += kBK) {
      {
        const int gr = row0 + xr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = k0 + xc + j;
          xs[xc + j][xr] = (gr < m && kk < c)
              ? to_f32(x[(long long)gr * k + xcol0 + kk]) : 0.f;
        }
        const int kk = k0 + wr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gc = col0 + wc + j;
          ws[wr][wc + j] = (kk < c && gc < f)
              ? to_f32(w[(long long)kk * f + gc]) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[kk][4 * ty]);
        const float4 b = *reinterpret_cast<const float4*>(&ws[kk][4 * tx]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) total[i][j] += acc[i][j];
  }

  T* out = static_cast<T*>(ranks.out[r]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + 4 * ty + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + 4 * tx + j;
      if (gc < f) out[(long long)gr * f + gc] = from_f32<T>(total[i][j]);
    }
  }
}

}  // namespace

// xs, ws, outs: host arrays of n device pointers (rank r's x (m, k), its
// (k / n, f) row shard of W, its (m, f) output); dtype 0 float32, 1
// bfloat16 (x, the shards and the outputs share it).  Returns the CUDA
// error of the launch (cudaErrorInvalidValue for arguments the kernel does
// not take).
extern "C" int repro_gather_matmul(const void* const* xs,
                                   const void* const* ws, void* const* outs,
                                   int n, int m, int k, int f, int dtype,
                                   void* stream) {
  if (n < 1 || n > kMaxRanks || m < 1 || f < 1 || k < n || k % n)
    return cudaErrorInvalidValue;
  const long long mtiles = (m + kBM - 1) / kBM;
  if (mtiles > 65535) return cudaErrorInvalidValue;
  Ranks ranks = {};
  for (int r = 0; r < n; ++r) {
    ranks.x[r] = xs[r];
    ranks.w[r] = ws[r];
    ranks.out[r] = outs[r];
  }
  dim3 grid((f + kBN - 1) / kBN, (unsigned)mtiles, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gather_matmul_kernel<float><<<grid, kThreads, 0, st>>>(ranks, n, m, k, f);
  else if (dtype == 1)
    gather_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        ranks, n, m, k, f);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
