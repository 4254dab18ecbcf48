// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan_pallas (the
// pallas_call at :83, body _ssd_kernel :22).  Same function and contract
// (ops.ssd_scan): x (b, s, h, p), dt (b, s, h) f32, A (h,) f32, B and C
// (b, s, g, n) with h % g == 0, head hh reading group hh / (h / g); the
// sequence is cut into s / Q chunks.  Per (batch row, head), chunk after
// chunk, with the (p, n) state carried from one chunk to the next
// (starting at zero):
//   xd_t   = x_t * dt_t,   acum = cumsum(A * dt) over the chunk,
//   y_q    = sum_{t <= q} (C_q . B_t) exp(acum_q - acum_t) xd_t
//            + exp(acum_q) * (prior . C_q),
//   state  = prior * exp(acum_end) + sum_t (xd_t exp(acum_end - acum_t)) B_t^T.
// y is written in x's type, the final state in f32; all arithmetic is f32
// but acum's running sum, which is kept in f64 and rounded to f32 once per
// position (as the plain version's cumsum): |acum| reaches ~180 at Q 256,
// and exp() turns acum's absolute rounding into a relative error of every
// decay, so an f32 running sum (or a parallel f32 scan) costs the result
// about 1e-4 of its value.
// acum decreases (A < 0, dt >= 0), so exp(acum_q - acum_t) overflows for
// q < t: it is computed only where q >= t and selected, never multiplied
// by a 0/1 mask (inf * 0 would be NaN).
//
// Design.  The TPU kernel walks a sequential grid (b, h, chunks) and holds
// a whole chunk (B, C, x, the (Q, Q) block) in VMEM.  Here one thread
// block owns one (batch row, head) and loops over the chunks itself, the
// state resident in shared memory.  A chunk does not fit a block's 227 KB
// at mamba2's shapes (Q 256, p 64, n 128: B and C 128 KB each in f32), so
// each chunk is cut into row tiles of kTile = 64: for each block of 64
// query rows, C's rows are staged once, the off-diagonal term is read from
// the state, and the tiles of 64 key rows at or below the diagonal are
// staged (B, and xd = x * dt) one after another to form the decay-masked
// (64, 64) score tile and add its product with xd.  A last sweep over the
// chunk's key tiles folds xd * exp(acum_end - acum_t) times B into the
// state.  Every product is a (64, 64)-output tile over 256 threads, each
// thread a 4 x 4 register tile at rows ty + 16i and columns tx + 16j, its
// operands read from shared memory whose row strides are odd (or padded)
// so that the 16 rows a warp reads fall in distinct banks.  p and n are at
// most 128 (mamba2: 64 and 128), Q any divisor of s.
//
// What bounds it on the H100: the operations.  Per (b, h, chunk) the
// causal work is Q(Q+1)/2 * 2(n + p) for the scores and their product,
// plus 4Qpn for the off-diagonal term and the state; at mamba2's shapes
// 21.0 MFLOP, against the f32 rate of the CUDA cores (67 TFLOP/s), since
// every product here runs on the CUDA cores in f32.  The bytes (each
// input read once, y and the state written once) are an order of
// magnitude below.
//
// What this simple design leaves on the table: parallelism at batch 1
// (one block per head: 80 blocks at mamba2's train shape for 132 SMs; a
// chunk-parallel form would compute each chunk's local state in parallel
// and pass states in a second, short sequential pass); the tensor cores
// (wgmma on bf16 or TF32 tiles); C.B^T, which is the same for every head
// of a group (mamba2 has g = 1: all 80 heads recompute it, as the TPU
// kernel does); a sequential scan of acum by one thread; and the
// shared-memory traffic of the 4 x 4 register tiles (8 loads for 16 FMAs
// a k step).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // query rows of a block, key rows of a tile
constexpr int kLdS = kTile + 1;  // the score tile's row stride
constexpr int kMaxDim = 128;    // head dim p and state size n, each
constexpr int kMaxSmem = 232448;

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
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

struct Shape {
  int b, s, h, p, g, n, Q;
  int ldn;  // row stride of the state, C and B tiles: n, made odd
};

__host__ __device__ inline int odd_stride(int n) { return n | 1; }

__host__ __device__ inline size_t smem_floats(int p, int n, int Q) {
  const int ldn = odd_stride(n);
  return (size_t)p * ldn          // state
         + 2 * (size_t)kTile * ldn  // C rows, B rows
         + (size_t)kTile * p        // xd rows
         + (size_t)kTile * kLdS     // score tile
         + 2 * (size_t)Q;           // acum, dt
}

// acc[i][j] += sum_{k < K} A(ty + 16i, k) * B(k, tx + 16j), with
// A(r, k) = a[r * sar + k * sak] and B(k, c) = b[k * sbk + c * sbc].
// Rows of A past rows_a and columns of B past cols_b read the last valid
// one (their results are never stored).
__device__ __forceinline__ void tile_mma(float (&acc)[4][4], int K,
                                         const float* a, int sar, int sak,
                                         int rows_a, const float* b, int sbk,
                                         int sbc, int cols_b) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  int ao[4], bo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ao[i] = min(ty + 16 * i, rows_a - 1) * sar;
    bo[i] = min(tx + 16 * i, cols_b - 1) * sbc;
  }
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[ao[i] + k * sak];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[k * sbk + bo[j]];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// dst[r * ld + k] = src[r * srow + k] as f32 for r < rows, k < n; rows
// rows..kTile-1 are zero.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src,
                                           long long srow, int rows, int n) {
  for (int e = threadIdx.x; e < kTile * n; e += kThreads) {
    const int r = e / n, k = e - r * n;
    dst[r * ld + k] = r < rows ? to_f32(src[r * srow + k]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ state_out, Shape sh) {
  extern __shared__ float smem[];
  const int p = sh.p, n = sh.n, Q = sh.Q, ldn = sh.ldn;
  float* st = smem;               // (p, ldn): the carried state
  float* cs = st + p * ldn;       // (kTile, ldn): C of a query block
  float* bs = cs + kTile * ldn;   // (kTile, ldn): B of a key tile
  float* xs = bs + kTile * ldn;   // (kTile, p): weighted x of a key tile
  float* ss = xs + kTile * p;     // (kTile, kLdS): decayed scores
  float* acum = ss + kTile * kLdS;  // (Q,)
  float* dts = acum + Q;            // (Q,)

  const int hh = blockIdx.x, ib = blockIdx.y;
  const int grp = hh / (sh.h / sh.g);
  const float a = A[hh];
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long xrow = (long long)sh.h * p;  // x, y: (b, s, h, p)
  const long long brow = (long long)sh.g * n;  // B, C: (b, s, g, n)
  const T* xb = x + (long long)ib * sh.s * xrow + (long long)hh * p;
  T* yb = y + (long long)ib * sh.s * xrow + (long long)hh * p;
  const float* dtb = dt + (long long)ib * sh.s * sh.h + hh;
  const T* bb = Bm + (long long)ib * sh.s * brow + (long long)grp * n;
  const T* cb = Cm + (long long)ib * sh.s * brow + (long long)grp * n;
  const int np = (p + kTile - 1) / kTile, nn = (n + kTile - 1) / kTile;

  for (int e = threadIdx.x; e < p * ldn; e += kThreads) st[e] = 0.f;

  for (int c = 0; c < sh.s / Q; ++c) {
    const long long base = (long long)c * Q;
    __syncthreads();  // the previous chunk's state is written
    for (int t = threadIdx.x; t < Q; t += kThreads)
      dts[t] = dtb[(base + t) * sh.h];
    __syncthreads();
    if (threadIdx.x == 0) {  // acum summed in f64, rounded once
      double run = 0.0;
      for (int t = 0; t < Q; ++t) {
        run += (double)(a * dts[t]);
        acum[t] = (float)run;
      }
    }
    __syncthreads();

    // y, one block of kTile query rows at a time
    for (int q0 = 0; q0 < Q; q0 += kTile) {
      const int qn = min(kTile, Q - q0);
      stage_rows(cs, ldn, cb + (base + q0) * brow, brow, qn, n);
      __syncthreads();
      // (register arrays are indexed by unrolled constants only, with
      // the runtime piece counts as guards, so that they stay in registers)
      float acc[2][4][4];
      // off-diagonal: exp(acum_q) * (C_q . prior), the prior read as it
      // entered the chunk
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        zero(acc[pp]);
        if (pp < np)
          tile_mma(acc[pp], n, cs, ldn, 1, kTile, st + pp * kTile * ldn, 1,
                   ldn, p - pp * kTile);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty + 16 * i;
        const float e = q < Q ? expf(acum[q]) : 0.f;
#pragma unroll
        for (int pp = 0; pp < 2; ++pp)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[pp][i][j] *= e;
      }
      // diagonal: the key tiles at or below this query block
      for (int t0 = 0; t0 <= q0; t0 += kTile) {
        const int tn = min(kTile, Q - t0);
        stage_rows(bs, ldn, bb + (base + t0) * brow, brow, tn, n);
        for (int e = threadIdx.x; e < kTile * p; e += kThreads) {
          const int r = e / p, k = e - r * p;
          xs[e] = r < tn ? to_f32(xb[(base + t0 + r) * xrow + k]) *
                               dts[t0 + r]
                         : 0.f;
        }
        __syncthreads();
        float sc[4][4];
        zero(sc);
        tile_mma(sc, n, cs, ldn, 1, kTile, bs, 1, ldn, kTile);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int q = q0 + ty + 16 * i, t = t0 + tx + 16 * j;
            ss[(ty + 16 * i) * kLdS + tx + 16 * j] =
                (q < Q && q >= t) ? sc[i][j] * expf(acum[q] - acum[t]) : 0.f;
          }
        __syncthreads();
#pragma unroll
        for (int pp = 0; pp < 2; ++pp)
          if (pp < np)
            tile_mma(acc[pp], tn, ss, kLdS, 1, kTile, xs + pp * kTile, p, 1,
                     p - pp * kTile);
        __syncthreads();  // bs, xs, ss are restaged next
      }
#pragma unroll
      for (int pp = 0; pp < 2; ++pp)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = ty + 16 * i, k = pp * kTile + tx + 16 * j;
            if (r < qn && k < p)
              yb[(base + q0 + r) * xrow + k] = from_f32<T>(acc[pp][i][j]);
          }
    }

    // the state: prior * exp(acum_end) + sum_t xd_t exp(acum_end - acum_t)
    // B_t^T, in (64, 64) pieces of (p, n)
    const float aend = acum[Q - 1];
    const float dend = expf(aend);
    float sacc[4][4][4];  // piece u is rows pp = u / nn, columns u % nn
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int pp = u / nn, pn = u - pp * nn;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = pp * kTile + ty + 16 * i;
          const int k = pn * kTile + tx + 16 * j;
          sacc[u][i][j] = (u < np * nn && r < p && k < n)
                              ? st[r * ldn + k] * dend : 0.f;
        }
    }
    for (int t0 = 0; t0 < Q; t0 += kTile) {
      const int tn = min(kTile, Q - t0);
      stage_rows(bs, ldn, bb + (base + t0) * brow, brow, tn, n);
      for (int e = threadIdx.x; e < kTile * p; e += kThreads) {
        const int r = e / p, k = e - r * p;
        xs[e] = r < tn ? (to_f32(xb[(base + t0 + r) * xrow + k]) *
                          dts[t0 + r]) * expf(aend - acum[t0 + r])
                       : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int pp = u / nn, pn = u - pp * nn;
        if (u < np * nn)
          tile_mma(sacc[u], tn, xs + pp * kTile, 1, p, p - pp * kTile,
                   bs + pn * kTile, ldn, 1, n - pn * kTile);
      }
      __syncthreads();  // every read of st and of the tiles is done
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int pp = u / nn, pn = u - pp * nn;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = pp * kTile + ty + 16 * i;
          const int k = pn * kTile + tx + 16 * j;
          if (u < np * nn && r < p && k < n) st[r * ldn + k] = sacc[u][i][j];
        }
    }
  }
  __syncthreads();
  float* so = state_out + ((long long)ib * sh.h + hh) * p * n;
  for (int e = threadIdx.x; e < p * n; e += kThreads) {
    const int r = e / n, k = e - r * n;
    so[e] = st[r * ldn + k];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, void* state,
                   const Shape& sh, cudaStream_t stream) {
  const size_t smem = smem_floats(sh.p, sh.n, sh.Q) * sizeof(float);
  static size_t smem_set = 0;  // per instantiation: the largest granted
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const dim3 grid(sh.h, sh.b);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y),
      static_cast<float*>(state), sh);
  return cudaGetLastError();
}

}  // namespace

// x, B, C and y of one type (dtype 0 = float32, 1 = bfloat16), dt, A and
// the state float32, every tensor contiguous in the layout above.
// Returns cudaGetLastError() after the launch, or the error that kept it
// from launching (cudaErrorInvalidValue for a shape it does not take).
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* B, const void* C, void* y,
                              void* state, int b, int s, int h, int p, int g,
                              int n, int Q, int dtype, void* stream) {
  if (b < 1 || s < 1 || h < 1 || g < 1 || h % g != 0 || Q < 1 || s % Q ||
      p < 1 || p > kMaxDim || n < 1 || n > kMaxDim || b > 65535 ||
      smem_floats(p, n, Q) * sizeof(float) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const Shape sh{b, s, h, p, g, n, Q, odd_stride(n)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, dt, A, B, C, y, state, sh, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dt, A, B, C, y, state, sh, st);
  return (int)cudaErrorInvalidValue;
}
