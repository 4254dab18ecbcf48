// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a),
// hand-written CUDA C++: a chunk-parallel sequence of four kernels.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan_pallas (the
// pallas_call at :83, body _ssd_kernel :22).  Same function and contract
// (ops.ssd_scan): x (b, s, h, p), dt (b, s, h) f32, A (h,) f32, B and C
// (b, s, g, n) with h % g == 0, head hh reading group hh / (h / g); the
// sequence is cut into nc = s / Q chunks and the (p, n) state starts at
// zero.  Per (batch row, head) and chunk c, with xd_t = x_t * dt_t and
// acum = cumsum(A * dt) over the chunk:
//   y_q     = sum_{t <= q} (C_q . B_t) exp(acum_q - acum_t) xd_t
//             + exp(acum_q) * (C_q . entering_c),
//   S_c     = sum_t (xd_t exp(acum_end - acum_t)) B_t^T      (the chunk's
//             own state),
//   entering_{c+1} = entering_c * exp(acum_end) + S_c,  the last one the
//             final state.
// y is written in x's type, the final state in f32.  Numerics, as the
// plain version (kernels/ssd_scan.py::ssd_scan_plain):
// - acum is a sum in f64 rounded to f32 once per position: |acum| reaches
//   ~180 at Q 256 and exp() turns its absolute rounding into a relative
//   error of every decay, so an f32 sum (running or parallel) costs the
//   result about 1e-4 of its value.  Here a parallel f64 scan.
// - acum decreases (A < 0, dt >= 0), so exp(acum_q - acum_t) overflows for
//   q < t: it is computed only where q >= t and selected, never multiplied
//   by a 0/1 mask (inf * 0 would be NaN).
// - every product is f32 on the CUDA cores (TF32 would break the f32
//   tolerance of 1e-5), and the state pass rounds state * exp(acum_end)
//   and then the sum with S_c, as the plain version does.
//
// Design.  The TPU kernel walks a sequential grid (b, h, chunks) and holds
// a whole chunk in VMEM; a block per (b, h) walking its chunks (this
// file's first design) gave 80 blocks to 132 SMs at mamba2's train shape,
// 16 sequential chunk steps each.  Only the state hand-over is
// sequential, so the call launches, on one stream:
//   1. ssd_scores_kernel, per (b, group, chunk, lower-triangular pair of
//      64-row tiles): G = C . B^T into the workspace.  G does not depend
//      on the head, only on its group (mamba2 and zamba2 have g = 1), so
//      it is computed once per group and read by every head of it: at
//      mamba2's shape 8.4 of the 21.0 MFLOP a (head, chunk) took when
//      each head recomputed it.
//   2. ssd_states_kernel, per (b, h, chunk, 64 x 64 tile of (n, p)): acum
//      (into the workspace) and S_c^T = B^T . (xd exp(acum_end - acum)),
//      stored (n, p) in the workspace.
//   3. ssd_pass_kernel, per (b, h, 8 x 32 state tile): the nc-step
//      recurrence above; each S_c is replaced by the state entering chunk
//      c, the final state goes to the output.
//   4. ssd_outputs_kernel, per (b, h, chunk, 64 query rows, 64 columns of
//      p), the tiles with the most work first: exp(acum_q) (C_q .
//      entering_c), then the decayed score tiles at or below the diagonal
//      times xd; below the diagonal tile the decay is split into a factor
//      of the query row and one of the key, so that only the diagonal
//      tile exponentiates each (q, t) element.
// Every product is a 64 x 64 output tile over 128 threads, each an 8 x 4
// register tile (rows 4ty..+3 and 32+4ty..+3, columns 4tx..+3 or
// tx+16j), fed by float4 reads of shared memory laid out so that a warp's
// reads are conflict-free: 12 vector loads for 128 FMAs.  The operand
// tiles (32 deep) are staged in two shared-memory buffers, the next one
// loading while the current one is used: by cp.async in float32 when n
// and p are multiples of 4 and the pointers 16-byte aligned, else through
// registers, converted to f32 (bf16, other shapes).  Scaling (x * dt, the
// decay, the causal select) is applied to a tile after it lands, by the
// thread that staged it.
//
// Workspace (PyTorch's caching allocator, one buffer a call, float32,
// regions 256-byte aligned): G, b g nc T(T+1)/2 tiles of 64 x 64 (T =
// ceil(Q / 64)); acum, b h s; the states, b h nc n p.  At mamba2's train
// shape (b 1, s 4096, h 80, p 64, n 128, Q 256) 2.6 + 1.3 + 42.0 MB, at
// its serve prefill (b 8, s 512) 2.6 + 1.3 + 42.0 MB.
//
// What bounds it on the H100: the operations.  The causal work is, per
// (b, group, chunk), Q(Q+1)/2 * 2n for the scores, and per (b, h, chunk)
// Q(Q+1)/2 * 2p for their products with xd plus 4Qpn for the
// off-diagonal term and the state: 16.3 GFLOP at both of mamba2's
// shapes, 0.243 ms at the CUDA cores' f32 67 TFLOP/s; the bytes (inputs
// read once, y and the state written once) take 0.05 ms.  The 64 x 64
// tiles on the diagonal compute their upper halves too, and the
// off-diagonal term of chunk 0 is skipped (its entering state is zero).
//
// What is left on the table: the tensor cores for bf16 (wgmma; f32 stays
// on the CUDA cores for its tolerance), and an initial state, which
// context parallelism of the ssm family would need (ROADMAP queue 1 item
// 5).  The products run at about 45% of the f32 peak (PERF.md): 8 x 8
// register tiles on 64-thread blocks and three blocks an SM (no spills)
// both measured slower than this 8 x 4 tile at four blocks an SM.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // every kernel of the sequence
constexpr int kT = 64;          // rows and columns of an output tile
constexpr int kK = 32;          // depth of a staged operand tile
constexpr int kLdRK = kK + 4;   // row stride of a [row][k] tile: 4 mod 32
constexpr int kLdKC = kT;       // row stride of a [k][column] tile
constexpr int kTileRK = kT * kLdRK;  // floats of a [row][k] tile
constexpr int kTileKC = kK * kLdKC;  // floats of a [k][column] tile
constexpr int kMaxDim = 128;    // head dim p and state size n, each
constexpr long long kMaxSmem = 232448;  // shared memory a block may take
constexpr int kMinBlocks = 4;   // blocks an SM holds: 128 registers each
constexpr long long kAlign = 64;  // floats: workspace regions on 256 bytes

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
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int chunks(const Shape& sh) { return sh.s / sh.Q; }
__host__ __device__ inline int q_tiles(const Shape& sh) {
  return cdiv(sh.Q, kT);
}
__host__ __device__ inline int tile_pairs(const Shape& sh) {
  return q_tiles(sh) * (q_tiles(sh) + 1) / 2;
}
__host__ __device__ inline long long aligned(long long floats) {
  return (floats + kAlign - 1) / kAlign * kAlign;
}

// the workspace's regions, in floats from its start
struct Workspace {
  long long g_off, acum_off, s_off, floats;
};

__host__ __device__ inline Workspace workspace(const Shape& sh) {
  const long long g = (long long)sh.b * sh.g * chunks(sh) * tile_pairs(sh) *
                      kT * kT;
  const long long acum = (long long)sh.b * sh.h * sh.s;
  const long long st = (long long)sh.b * sh.h * chunks(sh) * sh.n * sh.p;
  Workspace w;
  w.g_off = 0;
  w.acum_off = aligned(g);
  w.s_off = w.acum_off + aligned(acum);
  w.floats = w.s_off + aligned(st);
  return w;
}

// dynamic shared memory of the two kernels that keep the chunk's acum
// (the states kernel also holds a double a warp, statically)
__host__ __device__ inline long long states_smem(int Q) {
  return (long long)sizeof(float) * (4 * kTileKC + 3LL * Q);
}
__host__ __device__ inline long long outputs_smem(int Q) {
  return (long long)sizeof(float) * (2 * kTileRK + 2 * kTileKC + 2LL * Q);
}
constexpr long long kScanSmem = (long long)sizeof(double) * (kThreads / 32);
constexpr int kScoresSmem = (int)sizeof(float) * 4 * kTileRK;  // static

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !ok
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// One operand tile of R rows and C columns from a row-major source (row
// stride srow elements) into shared memory (row stride ld floats), as
// f32; rows past `rows` and columns past `cols` are zero.  Thread tid
// stages the 4-element pieces tid + kThreads * i.  kVec (float32, cols a
// multiple of 4, 16-byte aligned rows): each piece is one cp.async, which
// `land` waits for; otherwise `start` loads the pieces into registers and
// `land` stores them.  `land` with a functor f stores f(row, column,
// value) for the valid elements of the thread's own pieces.
template <typename T, bool kVec, int R, int C>
struct Stage {
  static constexpr int kPieces = R * C / (4 * kThreads);
  static_assert(kPieces * 4 * kThreads == R * C, "tile and threads");
  float v[kVec ? 1 : kPieces][4];
  int rows, cols;

  __device__ __forceinline__ void start(float* dst, int ld, const T* src,
                                        long long srow, int rows_,
                                        int cols_) {
    rows = rows_;
    cols = cols_;
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int r = e / (C / 4), c = (e % (C / 4)) * 4;
      if constexpr (kVec) {
        const bool ok = r < rows && c < cols;
        cp_async16(dst + r * ld + c, ok ? src + r * srow + c : src, ok);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[i][u] = (r < rows && c + u < cols)
                        ? to_f32<T>(src[r * srow + c + u]) : 0.f;
      }
    }
    if constexpr (kVec) asm volatile("cp.async.commit_group;" ::: "memory");
  }

  __device__ __forceinline__ void land(float* dst, int ld) {
    land(dst, ld, [](int, int, float x) { return x; }, false);
  }

  template <class F>
  __device__ __forceinline__ void land(float* dst, int ld, F f,
                                       bool apply = true) {
    if constexpr (kVec) {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      if (!apply) return;
    }
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int r = e / (C / 4), c = (e % (C / 4)) * 4;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool ok = r < rows && c + u < cols;
        float* d = dst + r * ld + c + u;
        if constexpr (kVec) {
          if (ok) *d = f(r, c + u, *d);
        } else {
          *d = ok ? (apply ? f(r, c + u, v[i][u]) : v[i][u]) : 0.f;
        }
      }
    }
  }
};

// A thread's rows and columns of a 64 x 64 output tile
__device__ __forceinline__ int row_of(int i) {
  const int ty = threadIdx.x >> 4;
  return i < 4 ? 4 * ty + i : 28 + 4 * ty + i;
}
template <bool kBK>
__device__ __forceinline__ int col_of(int j) {
  const int tx = threadIdx.x & 15;
  return kBK ? 4 * tx + j : tx + 16 * j;
}

// acc[i][j] += sum_{k < kK} A(row_of(i), k) * B(k, col_of(j)), k in
// order.  A is stored [k][row] (kAK) or [row][k]; B [k][column] (kBK) or
// [column][k].  Every read is a float4: a warp's A reads are two
// addresses 4 rows apart, its [k][column] B reads 16 consecutive float4s
// and its [column][k] B reads 16 rows of stride 4 mod 32 floats, so no
// read takes more than the two wavefronts its bytes need.
template <bool kAK, bool kBK>
__device__ __forceinline__ void mma_tile(float (&acc)[8][4], const float* a,
                                         int lda, const float* b, int ldb) {
#pragma unroll 2
  for (int k = 0; k < kK; k += 4) {
    float av[4][8], bv[4][4];
    if constexpr (kAK) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float4 t = *reinterpret_cast<const float4*>(
              a + (k + u) * lda + row_of(4 * half));
          av[u][4 * half] = t.x;
          av[u][4 * half + 1] = t.y;
          av[u][4 * half + 2] = t.z;
          av[u][4 * half + 3] = t.w;
        }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 t =
            *reinterpret_cast<const float4*>(a + row_of(i) * lda + k);
        av[0][i] = t.x;
        av[1][i] = t.y;
        av[2][i] = t.z;
        av[3][i] = t.w;
      }
    }
    if constexpr (kBK) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 t =
            *reinterpret_cast<const float4*>(b + (k + u) * ldb + col_of<true>(0));
        bv[u][0] = t.x;
        bv[u][1] = t.y;
        bv[u][2] = t.z;
        bv[u][3] = t.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 t =
            *reinterpret_cast<const float4*>(b + col_of<false>(j) * ldb + k);
        bv[0][j] = t.x;
        bv[1][j] = t.y;
        bv[2][j] = t.z;
        bv[3][j] = t.w;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(av[u][i], bv[u][j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// steps k-steps over two buffers: start(step, buf) starts staging a
// step's tiles, land(step, buf) completes it, compute(step, buf) consumes
// it; step + 1 is staged while step is computed.
template <class Start, class Land, class Compute>
__device__ __forceinline__ void pipeline(int steps, Start start, Land land,
                                         Compute compute) {
  start(0, 0);
  land(0, 0);
  __syncthreads();
  for (int st = 0; st < steps; ++st) {
    const int buf = st & 1;
    const bool next = st + 1 < steps;
    if (next) start(st + 1, buf ^ 1);
    compute(st, buf);
    if (next) land(st + 1, buf ^ 1);
    __syncthreads();
  }
}

// acum[t] = (float) sum_{u <= t} (double)(a * dts[u]) for t < Q: each
// thread sums a run of consecutive positions in f64, a warp scan and the
// warps' totals give each run its f64 prefix.  Ends synchronised.
__device__ void chunk_cumsum(float* acum, const float* dts, float a, int Q,
                             double* part) {
  const int per = cdiv(Q, kThreads);
  const int t0 = min(Q, (int)threadIdx.x * per), t1 = min(Q, t0 + per);
  double tot = 0.0;
  for (int t = t0; t < t1; ++t) tot += (double)__fmul_rn(a, dts[t]);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double inc = tot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  double run = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) run = 0.0;
  if (lane == 31) part[warp] = inc;
  __syncthreads();
  double before = 0.0;
  for (int w = 0; w < warp; ++w) before += part[w];
  run += before;
  for (int t = t0; t < t1; ++t) {
    run += (double)__fmul_rn(a, dts[t]);
    acum[t] = (float)run;
  }
  __syncthreads();
}

// 1. G = C . B^T per (b, group, chunk), lower-triangular 64 x 64 tile
// pairs.  Grid (b g nc, T(T+1)/2): block (x, y) takes (b, group, chunk) x
// and pair y = qi(qi+1)/2 + ti, ti <= qi.  The tiles of a chunk are
// stored one after another, 64 x 64 floats each, rows and columns past Q
// zero.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssd_scores_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
                  float* __restrict__ G, Shape sh) {
  __shared__ __align__(16) float as[2][kTileRK];
  __shared__ __align__(16) float bs[2][kTileRK];
  const int nc = chunks(sh);
  const int c = blockIdx.x % nc, bg = blockIdx.x / nc;
  const int gi = bg % sh.g, ib = bg / sh.g;
  int qi = 0;
  while ((qi + 1) * (qi + 2) / 2 <= (int)blockIdx.y) ++qi;
  const int ti = blockIdx.y - qi * (qi + 1) / 2;
  const int q0 = qi * kT, t0 = ti * kT;
  const long long brow = (long long)sh.g * sh.n;
  const long long base =
      ((long long)ib * sh.s + (long long)c * sh.Q) * brow +
      (long long)gi * sh.n;
  const T* cq = Cm + base + q0 * brow;
  const T* bt = Bm + base + t0 * brow;
  const int qn = min(kT, sh.Q - q0), tn = min(kT, sh.Q - t0);
  Stage<T, kVec, kT, kK> sa, sb;
  float acc[8][4];
  zero(acc);
  pipeline(
      cdiv(sh.n, kK),
      [&](int st, int buf) {
        const int k0 = st * kK;
        sa.start(as[buf], kLdRK, cq + k0, brow, qn, sh.n - k0);
        sb.start(bs[buf], kLdRK, bt + k0, brow, tn, sh.n - k0);
      },
      [&](int, int buf) {
        sa.land(as[buf], kLdRK);
        sb.land(bs[buf], kLdRK);
      },
      [&](int, int buf) {
        mma_tile<false, false>(acc, as[buf], kLdRK, bs[buf], kLdRK);
      });
  float* out =
      G + ((long long)blockIdx.x * tile_pairs(sh) + blockIdx.y) * kT * kT;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[row_of(i) * kT + col_of<false>(j)] = acc[i][j];
}

// 2. Per (b, h, chunk): acum, and the chunk's own state S_c^T (n, p).
// Grid (b h nc, ceil(n/64) ceil(p/64)): block (x, y) takes (b, h, chunk)
// x, n tile y / ceil(p/64) and p tile y % ceil(p/64).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssd_states_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  float* __restrict__ acum_ws, float* __restrict__ S,
                  Shape sh) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double part[kThreads / 32];
  const int Q = sh.Q, n = sh.n, p = sh.p;
  float* as = smem;               // [2][kTileKC]: B, k = t, columns n
  float* bs = as + 2 * kTileKC;   // [2][kTileKC]: weighted x, columns p
  float* dts = bs + 2 * kTileKC;  // [Q]
  float* acum = dts + Q;          // [Q]
  float* dec = acum + Q;          // [Q]: exp(acum_end - acum_t)
  const int nc = chunks(sh);
  const int c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int hh = bh % sh.h, ib = bh / sh.h;
  const int npt = cdiv(p, kT);
  const int n0 = (blockIdx.y / npt) * kT, p0 = (blockIdx.y % npt) * kT;
  const int grp = hh / (sh.h / sh.g);
  const long long t_base = (long long)ib * sh.s + (long long)c * Q;

  for (int t = threadIdx.x; t < Q; t += kThreads)
    dts[t] = dt[(t_base + t) * sh.h + hh];
  __syncthreads();
  chunk_cumsum(acum, dts, A[hh], Q, part);
  const float aend = acum[Q - 1];
  for (int t = threadIdx.x; t < Q; t += kThreads) {
    dec[t] = expf(aend - acum[t]);
    if (blockIdx.y == 0) acum_ws[(long long)blockIdx.x * Q + t] = acum[t];
  }
  __syncthreads();

  const long long brow = (long long)sh.g * n, xrow = (long long)sh.h * p;
  const T* bsrc = Bm + t_base * brow + (long long)grp * n + n0;
  const T* xsrc = x + t_base * xrow + (long long)hh * p + p0;
  Stage<T, kVec, kK, kT> sa, sb;
  float acc[8][4];
  zero(acc);
  pipeline(
      cdiv(Q, kK),
      [&](int st, int buf) {
        const int t0 = st * kK;
        sa.start(as + buf * kTileKC, kLdKC, bsrc + t0 * brow, brow,
                 min(kK, Q - t0), n - n0);
        sb.start(bs + buf * kTileKC, kLdKC, xsrc + t0 * xrow, xrow,
                 min(kK, Q - t0), p - p0);
      },
      [&](int st, int buf) {
        const int t0 = st * kK;
        sa.land(as + buf * kTileKC, kLdKC);
        sb.land(bs + buf * kTileKC, kLdKC, [&](int r, int, float v) {
          return (v * dts[t0 + r]) * dec[t0 + r];
        });
      },
      [&](int, int buf) {
        mma_tile<true, true>(acc, as + buf * kTileKC, kLdKC,
                             bs + buf * kTileKC, kLdKC);
      });
  float* out = S + (long long)blockIdx.x * n * p;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = n0 + row_of(i), col = p0 + col_of<true>(0);
    if (r >= n) continue;
    float* d = out + (long long)r * p + col;
    if (kVec && col < p) {
      *reinterpret_cast<float4*>(d) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < p) d[j] = acc[i][j];
    }
  }
}

// 3. Per (b, h) and 8 x 32 tile of the (n, p) state, chunk after chunk:
// S_c becomes the state entering chunk c, and the state after the last
// chunk goes to the output (b, h, p, n) through a shared-memory transpose,
// so that the workspace's rows (p) are read and written 32 consecutive
// floats a warp and the output's (n) 8.  The next chunk's S is loaded
// before this chunk's entering state is stored.  Grid (b h, ceil(n/8)
// ceil(p/32)); thread tid takes column tid % 32 and rows tid / 32 + 4k.
constexpr int kPassRows = 8, kPassCols = 32;
constexpr int kPassPer = kPassRows * kPassCols / kThreads;

__global__ void __launch_bounds__(kThreads)
ssd_pass_kernel(const float* __restrict__ acum_ws, float* __restrict__ S,
                float* __restrict__ state_out, Shape sh) {
  __shared__ float tile[kPassRows][kPassCols + 1];
  const int n = sh.n, p = sh.p, nc = chunks(sh);
  const int ppt = cdiv(p, kPassCols);
  const int n0 = (blockIdx.y / ppt) * kPassRows;
  const int p0 = (blockIdx.y % ppt) * kPassCols;
  const int col = threadIdx.x % kPassCols, row = threadIdx.x / kPassCols;
  const long long bh = blockIdx.x, np = (long long)n * p;
  float* sb = S + bh * nc * np;
  const float* ab = acum_ws + bh * nc * sh.Q + sh.Q - 1;  // acum_end
  bool ok[kPassPer];
  long long off[kPassPer];
  float st[kPassPer], cur[kPassPer];
#pragma unroll
  for (int k = 0; k < kPassPer; ++k) {
    const int r = n0 + row + (kThreads / kPassCols) * k;
    ok[k] = r < n && p0 + col < p;
    off[k] = (long long)r * p + p0 + col;
    st[k] = 0.f;
    cur[k] = ok[k] ? sb[off[k]] : 0.f;
  }
  float aend = ab[0];
  for (int c = 0; c < nc; ++c) {
    float nxt[kPassPer], anext = 0.f;
    if (c + 1 < nc) {
#pragma unroll
      for (int k = 0; k < kPassPer; ++k)
        nxt[k] = ok[k] ? sb[(c + 1) * np + off[k]] : 0.f;
      anext = ab[(long long)(c + 1) * sh.Q];
    }
    const float d = expf(aend);
#pragma unroll
    for (int k = 0; k < kPassPer; ++k) {
      if (ok[k]) sb[c * np + off[k]] = st[k];
      st[k] = __fadd_rn(__fmul_rn(st[k], d), cur[k]);
      cur[k] = nxt[k];
    }
    aend = anext;
  }
#pragma unroll
  for (int k = 0; k < kPassPer; ++k)
    tile[row + (kThreads / kPassCols) * k][col] = st[k];
  __syncthreads();
  // thread tid now writes n index n0 + tid % 8 of p rows tid / 8 + 16k
#pragma unroll
  for (int k = 0; k < kPassPer; ++k) {
    const int pl = threadIdx.x / kPassRows + (kThreads / kPassRows) * k;
    const int nl = threadIdx.x % kPassRows;
    if (p0 + pl < p && n0 + nl < n)
      state_out[(bh * p + p0 + pl) * n + n0 + nl] = tile[nl][pl];
  }
}

// 4. y per (b, h, chunk, 64 query rows, 64 columns of p).  Grid (b h nc
// ceil(p/64), ceil(Q/64)): block (x, y) takes (b, h, chunk) x /
// ceil(p/64), p tile x % ceil(p/64), and query tile ceil(Q/64) - 1 - y
// (the tiles with the most score tiles first).  Below the diagonal tile
// (t < q0 <= q) the decay splits at the tile's first row q0:
// exp(acum_q - acum_t) = exp(acum_q - acum_q0) exp(acum_q0 - acum_t), both
// exponents <= 0, so the score tiles are used as stored, the key rows of
// xd take exp(acum_q0 - acum_t) and the sum so far takes
// exp(acum_q - acum_q0) once; only the diagonal tile selects and
// exponentiates each (q, t) element.  The off-diagonal term likewise is
// exp(acum_q - acum_q0) (exp(acum_q0) C_q . entering).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssd_outputs_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const T* __restrict__ Cm, const float* __restrict__ G,
                   const float* __restrict__ acum_ws,
                   const float* __restrict__ S, T* __restrict__ y,
                   Shape sh) {
  extern __shared__ __align__(16) float smem[];
  const int Q = sh.Q, n = sh.n, p = sh.p;
  float* as = smem;               // [2][kTileRK]: C, then scores
  float* bs = as + 2 * kTileRK;   // [2][kTileKC]: entering state, then xd
  float* acum = bs + 2 * kTileKC;  // [Q]
  float* dtw = acum + Q;           // [Q]: dt_t exp(acum_q0 - acum_t), t < q0;
                                   // dt_t from q0 on
  const int nc = chunks(sh), npt = cdiv(p, kT);
  const int bhc = blockIdx.x / npt, p0 = (blockIdx.x % npt) * kT;
  const int c = bhc % nc, bh = bhc / nc;
  const int hh = bh % sh.h, ib = bh / sh.h;
  const int qi = q_tiles(sh) - 1 - blockIdx.y;
  const int q0 = qi * kT, qn = min(kT, Q - q0);
  const int grp = hh / (sh.h / sh.g);
  const long long t_base = (long long)ib * sh.s + (long long)c * Q;
  const long long brow = (long long)sh.g * n, xrow = (long long)sh.h * p;

  const int tmax = min(Q, q0 + kT);  // positions this tile reads
  for (int t = threadIdx.x; t < tmax; t += kThreads)
    acum[t] = acum_ws[(long long)bhc * Q + t];
  __syncthreads();
  const float a0 = acum[q0];
  for (int t = threadIdx.x; t < tmax; t += kThreads) {
    const float d = dt[(t_base + t) * sh.h + hh];
    dtw[t] = t < q0 ? d * expf(a0 - acum[t]) : d;
  }
  __syncthreads();

  float acc[8][4];
  zero(acc);
  if (c > 0) {  // the state entering chunk 0 is zero
    const T* cq = Cm + (t_base + q0) * brow + (long long)grp * n;
    const float* ent = S + (long long)bhc * n * p + p0;
    Stage<T, kVec, kT, kK> sa;
    Stage<float, kVec, kK, kT> sb;
    pipeline(
        cdiv(n, kK),
        [&](int st, int buf) {
          const int k0 = st * kK;
          sa.start(as + buf * kTileRK, kLdRK, cq + k0, brow, qn, n - k0);
          sb.start(bs + buf * kTileKC, kLdKC, ent + (long long)k0 * p, p,
                   min(kK, n - k0), p - p0);
        },
        [&](int, int buf) {
          sa.land(as + buf * kTileRK, kLdRK);
          sb.land(bs + buf * kTileKC, kLdKC);
        },
        [&](int, int buf) {
          mma_tile<false, true>(acc, as + buf * kTileRK, kLdRK,
                                bs + buf * kTileKC, kLdKC);
        });
    const float e0 = expf(a0);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= e0;
  }

  // the score tiles (qi, 0..qi), 32 keys a step; the diagonal one last
  const float* gq = G + ((((long long)ib * sh.g + grp) * nc + c) *
                             tile_pairs(sh) + qi * (qi + 1) / 2) * kT * kT;
  const T* xsrc = x + t_base * xrow + (long long)hh * p + p0;
  const int diag = qi * (kT / kK);  // the first step of the diagonal tile
  Stage<float, true, kT, kK> sg;  // the workspace: always aligned
  Stage<T, kVec, kK, kT> sx;
  pipeline(
      (qi + 1) * (kT / kK),
      [&](int st, int buf) {
        const int ti = st / (kT / kK), kk = (st % (kT / kK)) * kK;
        const int t0 = ti * kT + kk;
        sg.start(as + buf * kTileRK, kLdRK, gq + (long long)ti * kT * kT + kk,
                 kT, kT, kK);
        sx.start(bs + buf * kTileKC, kLdKC, xsrc + t0 * xrow, xrow,
                 min(kK, Q - t0), p - p0);
      },
      [&](int st, int buf) {
        const int t0 = (st / (kT / kK)) * kT + (st % (kT / kK)) * kK;
        if (st < diag) {
          sg.land(as + buf * kTileRK, kLdRK);
        } else {
          sg.land(as + buf * kTileRK, kLdRK, [&](int r, int col, float v) {
            const int q = q0 + r, t = t0 + col;
            return (q >= t && q < Q) ? v * expf(acum[q] - acum[t]) : 0.f;
          });
        }
        sx.land(bs + buf * kTileKC, kLdKC,
                [&](int r, int, float v) { return v * dtw[t0 + r]; });
      },
      [&](int st, int buf) {
        if (st == diag) {  // exp(acum_q - acum_q0) for the sum so far
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int q = q0 + row_of(i);
            const float e = q < Q ? expf(acum[q] - a0) : 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] *= e;
          }
        }
        mma_tile<false, true>(acc, as + buf * kTileRK, kLdRK,
                              bs + buf * kTileKC, kLdKC);
      });

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row_of(i), col = p0 + col_of<true>(0);
    if (r >= qn) continue;
    T* d = y + (t_base + q0 + r) * xrow + (long long)hh * p + col;
    if constexpr (kVec) {
      if (col < p)
        *reinterpret_cast<float4*>(d) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < p) d[j] = from_f32<T>(acc[i][j]);
    }
  }
}

// the launch of each kernel: grid x, grid y, threads, shared memory bytes
struct Plan {
  long long k[4][4];  // scores, states, pass, outputs
  long long workspace_bytes;
};

bool shape_ok(const Shape& sh) {
  if (sh.b < 1 || sh.s < 1 || sh.h < 1 || sh.g < 1 || sh.h % sh.g != 0 ||
      sh.Q < 1 || sh.s % sh.Q || sh.p < 1 || sh.p > kMaxDim || sh.n < 1 ||
      sh.n > kMaxDim)
    return false;
  // the largest chunk is the one whose acum still fits both blocks
  if (states_smem(sh.Q) + kScanSmem > kMaxSmem ||
      outputs_smem(sh.Q) > kMaxSmem)
    return false;
  const long long bhc = (long long)sh.b * sh.h * chunks(sh);
  return bhc * cdiv(sh.p, kT) <= 0x7fffffffLL &&
         (long long)sh.b * sh.g * chunks(sh) <= 0x7fffffffLL;
}

Plan plan_of(const Shape& sh) {
  Plan pl;
  const long long bhc = (long long)sh.b * sh.h * chunks(sh);
  const long long rows[4][4] = {
      {(long long)sh.b * sh.g * chunks(sh), tile_pairs(sh), kThreads,
       kScoresSmem},
      {bhc, (long long)cdiv(sh.n, kT) * cdiv(sh.p, kT), kThreads,
       states_smem(sh.Q) + kScanSmem},
      {(long long)sh.b * sh.h,
       (long long)cdiv(sh.n, kPassRows) * cdiv(sh.p, kPassCols), kThreads,
       (long long)sizeof(float) * kPassRows * (kPassCols + 1)},
      {bhc * cdiv(sh.p, kT), q_tiles(sh), kThreads, outputs_smem(sh.Q)}};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) pl.k[i][j] = rows[i][j];
  pl.workspace_bytes = workspace(sh).floats * (long long)sizeof(float);
  return pl;
}

template <class K>
cudaError_t allow_smem(K kernel, int bytes, int* granted) {
  if (bytes <= *granted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *granted = bytes;
  return e;
}

template <typename T, bool kVec>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, void* state,
                   void* ws, const Shape& sh, cudaStream_t stream) {
  static int states_granted = 48 * 1024, outputs_granted = 48 * 1024;
  const Plan pl = plan_of(sh);
  const Workspace w = workspace(sh);
  float* base = static_cast<float*>(ws);
  float* G = base + w.g_off;
  float* acum = base + w.acum_off;
  float* S = base + w.s_off;
  const int st_smem = (int)states_smem(sh.Q);
  const int out_smem = (int)outputs_smem(sh.Q);
  cudaError_t e = allow_smem(ssd_states_kernel<T, kVec>, st_smem,
                             &states_granted);
  if (e != cudaSuccess) return e;
  e = allow_smem(ssd_outputs_kernel<T, kVec>, out_smem, &outputs_granted);
  if (e != cudaSuccess) return e;
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  const float* dtf = static_cast<const float*>(dt);
  auto grid = [&](int i) {
    return dim3((unsigned)pl.k[i][0], (unsigned)pl.k[i][1]);
  };
  ssd_scores_kernel<T, kVec><<<grid(0), kThreads, 0, stream>>>(Bt, Ct, G, sh);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_states_kernel<T, kVec><<<grid(1), kThreads, st_smem, stream>>>(
      xt, dtf, static_cast<const float*>(A), Bt, acum, S, sh);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_pass_kernel<<<grid(2), kThreads, 0, stream>>>(
      acum, S, static_cast<float*>(state), sh);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_outputs_kernel<T, kVec><<<grid(3), kThreads, out_smem, stream>>>(
      xt, dtf, Ct, G, acum, S, static_cast<T*>(y), sh);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// The launches of one call: plan[4 i + 0..3] = grid x, grid y, threads and
// shared memory bytes of a block of kernel i (0 scores, 1 states, 2 pass,
// 3 outputs), plan[16] = the workspace's bytes.  Returns
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int repro_ssd_scan_plan(int b, int s, int h, int p, int g, int n,
                                   int Q, long long* plan) {
  const Shape sh{b, s, h, p, g, n, Q};
  if (!shape_ok(sh)) return (int)cudaErrorInvalidValue;
  const Plan pl = plan_of(sh);
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) plan[4 * i + j] = pl.k[i][j];
  plan[16] = pl.workspace_bytes;
  return 0;
}

// x, B, C and y of one type (dtype 0 = float32, 1 = bfloat16), dt, A and
// the state float32, every tensor contiguous in the layout above; the
// workspace at least repro_ssd_scan_plan's bytes, 16-byte aligned.  The
// four kernels go on `stream` one after another.  Returns
// cudaGetLastError() after the launches, or the error that kept them from
// launching (cudaErrorInvalidValue for a shape they do not take).
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* B, const void* C, void* y,
                              void* state, void* ws, long long ws_bytes,
                              int b, int s, int h, int p, int g, int n, int Q,
                              int dtype, void* stream) {
  const Shape sh{b, s, h, p, g, n, Q};
  if (!shape_ok(sh) || !aligned16(ws) ||
      ws_bytes < plan_of(sh).workspace_bytes)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = dtype == 0 && p % 4 == 0 && n % 4 == 0 && aligned16(x) &&
                   aligned16(B) && aligned16(C) && aligned16(y);
  if (dtype == 0 && vec)
    return (int)launch<float, true>(x, dt, A, B, C, y, state, ws, sh, st);
  if (dtype == 0)
    return (int)launch<float, false>(x, dt, A, B, C, y, state, ws, sh, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, false>(x, dt, A, B, C, y, state, ws,
                                             sh, st);
  return (int)cudaErrorInvalidValue;
}
