// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++: two
// paths behind one entry point, and the state sweep of ring attention.
//
// Numerics, every path.  The function and numerics of
// src/repro/kernels/flash_attention.py::flash_attention_pallas: q is
// pre-scaled in f32, the soft cap cap*tanh(s/cap) is applied before
// masking, the mask is
//   kp >= 0  &&  (!causal || rel >= 0)  &&  (window <= 0 || rel < window)
//            &&  q_segment == kv_segment,          rel = q_pos - kv_pos,
// masked scores take the finite NEG_INF = -2e38 (never -inf), the online
// softmax state (m, l, acc) is kept in f32, and the output is
// acc / max(l, 1e-30) rounded to the input type.  GQA maps q head h to kv
// head h / G, and the rows of a (batch, kv head) are the flattened
// (query position, head-in-group) pairs, row = s * G + g, so the G query
// heads that share a kv head read each K/V row once.  A set of keys in
// which every (row, key) pair is masked may be skipped: with finite
// NEG_INF it is an exact no-op on every row that has at least one valid
// key (corr = 1 and p = 0 once m is real, or the junk is wiped by
// corr = exp(NEG_INF - m) = 0 later).  Every path tests a tile's int32
// positions and segment ids before it reads any K/V byte of the tile, so
// decode reads only the written cache prefix and causal rows about half
// of the keys.
//
// Why f32 stays on the CUDA cores.  The main path is float32.  The
// tensor cores would run it as TF32 (about three decimal digits), which
// breaks the 1e-5 agreement with the plain version and with the JAX
// package, so every product here is an f32 fmaf.  The bf16 instantiation
// also computes in f32 on the CUDA cores; bf16 wgmma tiles are a later
// change (ROADMAP queue 1 item 11), as is a backward kernel (the
// backward is PyTorch code, kernels/flash_attention.py).
//
// ---------------------------------------------------------------------------
// Path 1, decode: attn_decode, split keys over a thread-block cluster.
// Replaces flash_attention_pallas (the pallas_call at :167) when the rows
// of a (batch, kv head) are few: rows = S * G <= 16 (<= 8 at head dim
// 256, whose K and V tiles take twice the shared memory).  qwen's decode
// has 6 rows, zamba2's 1.  Bound: the bytes of the valid K/V prefix
// against 3.35 TB/s; the operations, 4 * hd a (row, key) pair, are
// negligible.
//
// Grid (NSPLIT, KH, B) with cluster dims (NSPLIT, 1, 1): one cluster per
// (batch, kv head), so qwen's decode at batch 8 runs 128 blocks on 132 SMs
// (the tiled design ran 16).  Block x of the cluster takes the 64-key
// tiles t with t % NSPLIT == x.  NSPLIT is 8, the portable cluster size,
// halved while KH * NSPLIT > 64 (decode_split): MHA has many kv heads,
// and a fixed 8 gives zamba2's 32 kv heads at batch 8 2,048 blocks of
// about one tile each, whose time is the blocks' fixed cost times their
// waves.  The split depends on the model's KH and T only, never on the
// batch size or the other rows, so a row's result is the same in any
// batch.
//
// Per tile, after the test: K and V of its 64 keys arrive in shared
// memory by cp.async (K first, V behind it; zero-filled past T), and bf16
// widens to f32 at the load.  Scores: a thread a (row, key) pair, the dot
// product in d order from 16-byte fragments (q as f32 in shared memory,
// rows 16 bytes apart in the banks).  Online softmax: a warp a row, two
// keys a lane, m and l of the block's partial in shared memory.  P.V: a
// thread 4 dims of a row, its acc in registers, the keys in order.
// Keeping K/V rows in registers instead, a warp's lanes across the head
// dim and no shared-memory staging, needs a 32-lane shuffle reduce for
// every score and repeats the softmax's scalar work in every lane, which
// leaves a tile bound by instruction issue; here no cross-lane reduce
// touches a score.  The positions and segment
// ids of 4 of the block's tiles load at once (the first 4 with q), one
// key a thread; a tile in which no (row, key) pair is valid is skipped
// before any of its K/V is read.
//
// Combine, in a fixed order, with no second kernel and no scratch in
// device memory: each block holds one partial (m, l, acc) for its tiles;
// NSPLIT blocks of the cluster merge through distributed shared memory
// (mapa / ld.shared::cluster, after barrier.cluster), factors
// exp(m_x - M) per row and sums in rank order, by cluster rank 0, which
// writes acc / max(l, 1e-30); a last cluster barrier keeps every block
// resident until rank 0 has read it.  A split with nothing to do
// contributes (NEG_INF, 0, 0), an exact no-op in the merge once any key
// is valid.
//
// ---------------------------------------------------------------------------
// Path 2, tiled: attn_fwd (prefill, train) and attn_state (the cp state
// sweep), one templated tile loop.  attn_fwd replaces flash_attention_pallas
// (the pallas_call at :167, body _attn_kernel :62 / _attn_update :26) for
// more than the decode threshold's rows; attn_state replaces
// src/repro/kernels/flash_attention.py::flash_attention_state (the
// pallas_call at :416, body _attn_state_kernel :85).  Bound: the f32
// operations, 4 * hd per unmasked (row, key) pair, against the CUDA
// cores' 67 TFLOP/s (the bytes are far below it at these lengths).
//
// A block of 256 threads owns BQ flattened rows of one (batch, kv head)
// and walks kv tiles of BK keys.  The threads form a 16 x 16 grid (ty, tx):
// thread (ty, tx) computes the score micro-tile of rows ty + 16 i (i <
// BQ / 16) by keys tx + 16 j (j < BK / 16) from fragments of 4 elements
// it reads from shared memory as vectors (q as f32, K in its own type), and
// keeps acc for the same rows by dims tx * DV + 16 * DV * f.  The 16
// threads of a row are one half-warp, so the row max and sum reduce with
// four xor shuffles.  Probabilities go to shared memory as P[key][ty][i],
// so a thread reads its rows of one key as float4s.  Strides are padded
// by 16 bytes (q and K/V rows; P rows by 4 floats): rows 16 bytes apart
// in the banks, so the fragment loads of 16 neighbouring keys or rows
// are free of bank conflicts.
//
// K/V tiles arrive by cp.async (16 bytes, the zero-fill form for the
// ragged T edge) in two stages: tile k + 1 is in flight while tile k
// computes, and bf16 lands in shared memory as bf16 and widens to f32 at
// the fragment load.
// Positions and segment ids come first, 8 tiles at a time into a window
// in shared memory; one __syncthreads_or per tile decides which tiles
// some (row, key) pair of the block needs, and only those are copied.
//
// Tiles, per head dim: 32 and 64: BQ 64, BK 64; 128: BQ 64, BK 32 (two
// blocks an SM fit: 110 KB of shared memory in f32); 256: BQ 64, BK 32.
// BK divides 64: cp's chunks are multiples of 64 keys (see below).
//
// The state sweep.  The same tile loop, with STATE = true, sweeps q over
// one kv *chunk* with the online-softmax state (m, l, acc) entering as a
// carry and leaving unnormalized, all f32, in JAX's layout: m and l
// (B, S, H), acc (B, S, H, hd), contiguous; a row (position s,
// head-in-group g) of kv head kh is carry entry (b, s, h = kh * G + g).
// Each block reads its own rows' carry before its first tile and writes
// them after its last, and no other block touches those rows, so the
// carry is updated in place: one (m, l, acc) buffer serves every chunk
// call of a ring attention.  The context-parallel ring (core/cp.py)
// sweeps its chunks in ascending global order from a fresh carry
// (m = NEG_INF, l = acc = 0, what attn_fwd starts from); with every chunk
// a multiple of BK long the kv tiles are attn_fwd's, each row's
// arithmetic is the same whatever its place in a block (the sums run in
// d, key and lane order), and a skipped tile is an exact no-op on every
// row with a valid key, so acc / max(l, 1e-30) of the sweep equals
// attn_fwd on the gathered sequence bit for bit on those rows.  The update
// is written with explicit fmaf / __fmul_rn so that the compiler
// contracts nothing differently in the two instantiations.  The carry's
// round trip through device memory per chunk (about 50 MB at qwen's
// 4096 x 12 x 128 local rows, 15 us at 3.35 TB/s) is what it adds to
// attn_fwd's bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "odc_cluster.cuh"

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kThreads = 256;          // both paths
constexpr int kWarps = kThreads / 32;
constexpr int kPadPos = -1000000000;   // kv position of a column past T
// tiled path
constexpr int kTY = 16, kTX = 16;      // the thread grid: row x key groups
constexpr int kWindow = 8;             // tiles whose positions load at once
// decode path
constexpr int kSplit = 8;              // blocks of a cluster, at most
constexpr int kDecodeTile = 64;        // keys of a tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;        // attn_fwd: (B, S, H, hd) at o_s*
  float* m;         // the state sweep: the carry, updated in place
  float* l;
  float* acc;
  const int* qpos;  // (B, S)
  const int* kpos;  // (B, T)
  const int* qseg;  // (B, S) or null: all segment 0
  const int* kseg;  // (B, T) or null: all segment 0
  int B, S, T, H, KH;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window;
  float softcap, scale;
};

template <typename T>
__device__ __forceinline__ float load_f32(const T* p);
template <>
__device__ __forceinline__ float load_f32<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ void store_f32(T* p, float x);
template <>
__device__ __forceinline__ void store_f32<float>(float* p, float x) {
  *p = x;
}
template <>
__device__ __forceinline__ void store_f32<__nv_bfloat16>(__nv_bfloat16* p,
                                                         float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ void widen2(uint32_t u, float* x) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  x[0] = f.x;
  x[1] = f.y;
}

// N consecutive elements at p (aligned to N elements) as f32: one vector
// load of 8 or 16 bytes, two for 8 floats.
template <int N>
__device__ __forceinline__ void ldv(const float* p, float* x) {
  static_assert(N == 2 || N == 4 || N == 8, "");
  if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  } else {
#pragma unroll
    for (int h = 0; h < N / 4; ++h) {
      const float4 a = reinterpret_cast<const float4*>(p)[h];
      x[4 * h] = a.x; x[4 * h + 1] = a.y; x[4 * h + 2] = a.z;
      x[4 * h + 3] = a.w;
    }
  }
}
template <int N>
__device__ __forceinline__ void ldv(const __nv_bfloat16* p, float* x) {
  static_assert(N == 2 || N == 4 || N == 8, "");
  if constexpr (N == 2) {
    widen2(*reinterpret_cast<const uint32_t*>(p), x);
  } else if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    widen2(u.x, x); widen2(u.y, x + 2);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    widen2(u.x, x); widen2(u.y, x + 2); widen2(u.z, x + 4);
    widen2(u.w, x + 6);
  }
}

// 16 bytes from device to shared memory, asynchronously; bytes < 16
// zero-fills the rest (0: a column past T).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(odc_smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// f32 at `local` (a shared address of this block) in cluster rank `rank`.
__device__ __forceinline__ float ld_cluster(const float* local, int rank) {
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(x) : "r"(odc_mapa(odc_smem_u32(local), rank))
               : "memory");
  return x;
}

__device__ __forceinline__ bool pair_valid(const Params& p, int qp, int qs,
                                           int kp, int ks) {
  bool valid = kp >= 0 && qs == ks;
  if (valid) {
    const int rel = qp - kp;
    if (p.causal) valid = rel >= 0;
    if (valid && p.window > 0) valid = rel < p.window;
  }
  return valid;
}

// ===========================================================================
// path 2: the tiled loop (attn_fwd, attn_state)
// ===========================================================================
template <typename T, int HD, int BQ, int BK>
struct Tiled {
  static constexpr int RM = BQ / kTY;   // rows a thread
  static constexpr int CN = BK / kTX;   // keys a thread
  static constexpr int DN = HD / kTX;   // acc dims a thread
  static constexpr int DV = DN < 4 ? DN : 4;  // dims of one V fragment
  static constexpr int NF = DN / DV;    // V fragments a key
  static constexpr int DK = 4;                // elements of a K fragment
  static constexpr int LDQ = HD + 4;          // floats
  static constexpr int LDK = HD + 16 / sizeof(T);  // elements of T
  static constexpr int LDP = BQ + 4;          // floats
  static constexpr int CHUNKS = HD * sizeof(T) / 16;  // of a K/V row
  static constexpr size_t q_bytes = sizeof(float) * BQ * LDQ;
  static constexpr size_t kv_bytes = sizeof(T) * BK * LDK;  // one stage
  static constexpr size_t p_bytes = sizeof(float) * BK * LDP;
  static constexpr size_t pos_bytes =
      sizeof(int) * (2 * BQ + 2 * kWindow * BK + 2 * 2 * BK);
  static constexpr size_t smem = q_bytes + 4 * kv_bytes + p_bytes + pos_bytes;
  // two blocks an SM when their shared memory fits (228 KB an SM, 1 KB
  // of it reserved per block): then at most 128 registers a thread
  static constexpr int MIN_BLOCKS = 2 * (smem + 1024) <= 233472 ? 2 : 1;
  static_assert(RM % 4 == 0 && RM * CN <= 32 && DN % DV == 0, "");
};

template <typename T, int HD, int BQ, int BK, bool STATE>
__device__ __forceinline__ void tiled_body(const Params& p) {
  using C = Tiled<T, HD, BQ, BK>;
  constexpr int RM = C::RM, CN = C::CN, DN = C::DN, DV = C::DV, NF = C::NF;
  constexpr int DK = C::DK, LDQ = C::LDQ, LDK = C::LDK, LDP = C::LDP;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);           // (BQ, LDQ)
  T* Ks = reinterpret_cast<T*>(smem_raw + C::q_bytes);      // 2 x (BK, LDK)
  T* Vs = Ks + 2 * BK * LDK;                                // 2 x (BK, LDK)
  float* Ps = reinterpret_cast<float*>(Vs + 2 * BK * LDK);  // (BK, LDP)
  int* qpos_s = reinterpret_cast<int*>(Ps + BK * LDP);
  int* qseg_s = qpos_s + BQ;
  int* kpos_w = qseg_s + BQ;            // the window: kWindow x BK
  int* kseg_w = kpos_w + kWindow * BK;
  int* kpos_st = kseg_w + kWindow * BK;  // per stage: 2 x BK
  int* kseg_st = kpos_st + 2 * BK;

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* out = static_cast<T*>(p.out);

  const int G = p.H / p.KH;
  const int rows = p.S * G;
  const int r0 = blockIdx.x * BQ;
  const int kh = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / kTX, tx = tid % kTX;

  for (int i = tid; i < BQ * HD; i += kThreads) {
    const int rr = i / HD, d = i % HD, row = r0 + rr;
    float x = 0.f;
    if (row < rows) {
      const int s = row / G, h = kh * G + row % G;
      x = load_f32(q + b * p.q_sb + s * p.q_ss + h * p.q_sh + d) * p.scale;
    }
    Qs[rr * LDQ + d] = x;
  }
  for (int i = tid; i < BQ; i += kThreads) {
    const int row = r0 + i;
    const int s = row < rows ? row / G : 0;
    qpos_s[i] = p.qpos[b * p.S + s];
    qseg_s[i] = p.qseg ? p.qseg[b * p.S + s] : 0;
  }

  // this thread's rows ty + kTY * i, keys tx + kTX * j, dims
  // tx * DV + kTX * DV * f + e
  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DN; ++e) acc[i][e] = 0.f;
  }
  auto carry_row = [&](int i) {  // carry entry (b, s, h) of row i
    const int row = r0 + ty + kTY * i;
    return (b * p.S + row / G) * p.H + kh * G + row % G;
  };
  if (STATE) {  // carry in
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      if (r0 + ty + kTY * i >= rows) continue;
      const long long cr = carry_row(i);
      m[i] = p.m[cr];
      l[i] = p.l[cr];
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int e = 0; e < DV; ++e)
          acc[i][f * DV + e] = p.acc[cr * HD + tx * DV + kTX * DV * f + e];
    }
  }

  // the valid (row, key) pairs of this thread in a tile's positions
  auto pair_bits = [&](const int* kp, const int* ks) {
    unsigned ok = 0u;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + kTY * i;
      if (r0 + r >= rows) continue;
      const int qp = qpos_s[r], qs = qseg_s[r];
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int c = tx + kTX * j;
        ok |= unsigned(pair_valid(p, qp, qs, kp[c], ks[c])) << (i * CN + j);
      }
    }
    return ok;
  };

  // The first tile at or after t that some pair of the block needs
  // (n_tiles if none), from the positions alone.  Block-uniform.
  const int n_tiles = (p.T + BK - 1) / BK;
  int w0 = -(1 << 30);
  unsigned need = 0u;
  auto find_next = [&](int t) {
    while (t < n_tiles) {
      if (t >= w0 + kWindow) {
        w0 = t;
        __syncthreads();  // no thread still reads the old window
        for (int i = tid; i < kWindow * BK; i += kThreads) {
          const long long tt = (long long)w0 * BK + i;
          const bool in = tt < p.T;
          kpos_w[i] = in ? p.kpos[b * p.T + tt] : kPadPos;
          kseg_w[i] = (in && p.kseg) ? p.kseg[b * p.T + tt] : 0;
        }
        __syncthreads();
        need = 0u;
#pragma unroll
        for (int w = 0; w < kWindow; ++w) {
          const bool any = w0 + w < n_tiles &&
                           pair_bits(kpos_w + w * BK, kseg_w + w * BK) != 0u;
          need |= unsigned(__syncthreads_or(any) != 0) << w;
        }
      }
      const unsigned rest = need >> (t - w0);
      if (rest) return t + __ffs(rest) - 1;
      t = w0 + kWindow;
    }
    return n_tiles;
  };

  // K/V of tile kt into stage st, and its positions from the window
  auto issue = [&](int kt, int st) {
    constexpr int EC = 16 / sizeof(T);  // elements of a chunk
    T* kd = Ks + st * BK * LDK;
    T* vd = Vs + st * BK * LDK;
#pragma unroll 1
    for (int i = tid; i < BK * C::CHUNKS; i += kThreads) {
      const int c = i / C::CHUNKS, e0 = (i % C::CHUNKS) * EC;
      const long long t = (long long)kt * BK + c;
      const bool in = t < p.T;
      const T* ks = k + b * p.k_sb + t * p.k_st + kh * p.k_sh + e0;
      const T* vs = v + b * p.v_sb + t * p.v_st + kh * p.v_sh + e0;
      cp_async16(kd + c * LDK + e0, in ? ks : k, in ? 16 : 0);
      cp_async16(vd + c * LDK + e0, in ? vs : v, in ? 16 : 0);
    }
    for (int i = tid; i < BK; i += kThreads) {
      kpos_st[st * BK + i] = kpos_w[(kt - w0) * BK + i];
      kseg_st[st * BK + i] = kseg_w[(kt - w0) * BK + i];
    }
  };

  int cur = find_next(0), st = 0;
  if (cur < n_tiles) issue(cur, 0);
  cp_async_commit();
  while (cur < n_tiles) {
    const int nxt = find_next(cur + 1);
    if (nxt < n_tiles) issue(nxt, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile cur have landed
    __syncthreads();     // and every thread's

    const unsigned ok = pair_bits(kpos_st + st * BK, kseg_st + st * BK);
    const T* Kt = Ks + st * BK * LDK;
    const T* Vt = Vs + st * BK * LDK;

    float sc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) sc[i][j] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < HD; d0 += DK) {
      float kf[CN][DK];
#pragma unroll
      for (int j = 0; j < CN; ++j)
        ldv<DK>(Kt + (tx + kTX * j) * LDK + d0, kf[j]);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        float qf[DK];
        ldv<DK>(Qs + (ty + kTY * i) * LDQ + d0, qf);
#pragma unroll
        for (int e = 0; e < DK; ++e)
#pragma unroll
          for (int j = 0; j < CN; ++j)
            sc[i][j] = fmaf(qf[e], kf[j][e], sc[i][j]);
      }
    }

    float corr[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        float x = sc[i][j];
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        x = ((ok >> (i * CN + j)) & 1u) ? x : kNegInf;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = kTX / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float pj = expf(sc[i][j] - m_new);
        sum += pj;
        sc[i][j] = pj;
      }
#pragma unroll
      for (int o = kTX / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = fmaf(l[i], corr[i], sum);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < CN; ++j)
#pragma unroll
      for (int i = 0; i < RM; i += 4)
        *reinterpret_cast<float4*>(Ps + (tx + kTX * j) * LDP + ty * RM + i) =
            make_float4(sc[i][j], sc[i + 1][j], sc[i + 2][j], sc[i + 3][j]);
    __syncthreads();  // P complete

#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int e = 0; e < DN; ++e) acc[i][e] = __fmul_rn(acc[i][e], corr[i]);
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pf[RM], vf[DN];
      ldv<RM>(Ps + c * LDP + ty * RM, pf);
#pragma unroll
      for (int f = 0; f < NF; ++f)
        ldv<DV>(Vt + c * LDK + tx * DV + kTX * DV * f, vf + f * DV);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int e = 0; e < DN; ++e) acc[i][e] = fmaf(pf[i], vf[e], acc[i][e]);
    }
    __syncthreads();  // stage st and P are free again
    st ^= 1;
    cur = nxt;
  }
  cp_async_wait<0>();  // nothing is in flight at exit

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = r0 + ty + kTY * i;
    if (row >= rows) continue;
    if (STATE) {  // carry out, unnormalized
      const long long cr = carry_row(i);
      if (tx == 0) {
        p.m[cr] = m[i];
        p.l[cr] = l[i];
      }
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int e = 0; e < DV; ++e)
          p.acc[cr * HD + tx * DV + kTX * DV * f + e] = acc[i][f * DV + e];
    } else {
      const int s = row / G, h = kh * G + row % G;
      const float denom = fmaxf(l[i], 1e-30f);
      T* o = out + b * p.o_sb + s * p.o_ss + h * p.o_sh;
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int e = 0; e < DV; ++e)
          store_f32(o + tx * DV + kTX * DV * f + e, acc[i][f * DV + e] / denom);
    }
  }
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads, (Tiled<T, HD, BQ, BK>::MIN_BLOCKS))
    attn_fwd(Params p) {
  tiled_body<T, HD, BQ, BK, false>(p);
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads, (Tiled<T, HD, BQ, BK>::MIN_BLOCKS))
    attn_state(Params p) {
  tiled_body<T, HD, BQ, BK, true>(p);
}

// ===========================================================================
// path 1: decode (attn_decode)
// ===========================================================================
// The rows threshold of the decode path.
__host__ __device__ constexpr int decode_rows(int hd) {
  return hd == 256 ? 8 : 16;
}

// tiles whose positions a decode block loads at once: one key a thread
constexpr int kDecodeWin = kThreads / kDecodeTile;

template <typename T, int HD, int MAXR>
struct Decode {
  static constexpr int LDQ = HD + 4;               // floats
  static constexpr int LDK = HD + 16 / sizeof(T);  // elements of T
  static constexpr int LDS = kDecodeTile + 4;      // floats
  static constexpr int CHUNKS = HD * sizeof(T) / 16;  // of a K/V row
  static constexpr int QPT = (MAXR * HD + kThreads - 1) / kThreads;
  static constexpr int PPT = (MAXR * kDecodeTile + kThreads - 1) / kThreads;
  static constexpr int OPT = (MAXR * HD / 4 + kThreads - 1) / kThreads;
  // blocks an SM the registers must allow: MHA decode (rows <= 2) runs
  // many small blocks (B x KH x NSPLIT), in waves (hd 32 needs more than
  // the 64 registers of four)
  static constexpr int MIN_BLOCKS = MAXR <= 2 && HD >= 64 ? 4 : 2;
  static constexpr size_t kv_bytes = sizeof(T) * kDecodeTile * LDK;
  static constexpr size_t smem =
      2 * kv_bytes +
      sizeof(float) * (size_t(MAXR) * LDQ + size_t(MAXR) * LDS  // q, P
                       + 3 * MAXR                               // m, l, corr
                       + size_t(MAXR) * HD                      // the acc
                       + size_t(MAXR) * (kSplit + 1))           // factors, L
      + sizeof(int) * (2 * MAXR + 2 * kThreads);
};

// Blocks of a decode cluster for KH kv heads: 8, halved while the
// clusters of one batch row would hold more than 64 blocks (MHA).
__host__ __device__ constexpr int decode_split(int kh) {
  int n = kSplit;
  while (n > 1 && n * kh > 64) n /= 2;
  return n;
}

template <typename T, int HD, int MAXR>
__global__ void __launch_bounds__(kThreads, (Decode<T, HD, MAXR>::MIN_BLOCKS))
    attn_decode(Params p) {
  using D = Decode<T, HD, MAXR>;
  constexpr int LDQ = D::LDQ, LDK = D::LDK, LDS = D::LDS;
  constexpr int QPT = D::QPT, PPT = D::PPT, OPT = D::OPT;
  constexpr int EC = 16 / sizeof(T);  // elements of a 16-byte chunk

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);           // (kDecodeTile, LDK)
  T* Vs = Ks + kDecodeTile * LDK;
  float* qs = reinterpret_cast<float*>(Vs + kDecodeTile * LDK);  // (MAXR, LDQ)
  float* Ps = qs + MAXR * LDQ;                      // (MAXR, LDS) scores, p
  float* bacc = Ps + MAXR * LDS;                    // the block's partial,
  float* ms = bacc + MAXR * HD;                     // (MAXR, HD) acc, m, l,
  float* ls = ms + MAXR;                            // read by cluster rank 0
  float* cs = ls + MAXR;                            // (MAXR) corr of a tile
  float* fac = cs + MAXR;                           // (MAXR, kSplit)
  float* Ls = fac + MAXR * kSplit;                  // (MAXR)
  int* qpos_s = reinterpret_cast<int*>(Ls + MAXR);
  int* qseg_s = qpos_s + MAXR;
  int* kpos_w = qseg_s + MAXR;                      // (kDecodeWin, kDecodeTile)
  int* kseg_w = kpos_w + kThreads;

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* out = static_cast<T*>(p.out);

  const int split = blockIdx.x;  // = the cluster rank: the cluster spans x
  const int nsplit = gridDim.x;
  const int kh = blockIdx.y;
  const long long b = blockIdx.z;
  const int G = p.H / p.KH;
  const int rows = p.S * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the block's tiles t = split + nsplit * j, j < my_tiles
  const int n_tiles = (p.T + kDecodeTile - 1) / kDecodeTile;
  const int my_tiles =
      n_tiles > split ? (n_tiles - split + nsplit - 1) / nsplit : 0;

  // Positions and segment ids of the block's tiles j0 .. j0 + kDecodeWin
  // - 1, one key a thread, into registers (the first window's loads are in
  // flight with q's).
  auto window_load = [&](int j0, int& kp, int& ks) {
    const int j = j0 + tid / kDecodeTile;
    const long long tt =
        (long long)(split + nsplit * j) * kDecodeTile + tid % kDecodeTile;
    const bool in = j < my_tiles && tt < p.T;
    kp = in ? p.kpos[b * p.T + tt] : kPadPos;
    ks = (in && p.kseg) ? p.kseg[b * p.T + tt] : 0;
  };
  {
    float qv[QPT];
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      const int i = tid + kThreads * u, r = i / HD, d = i % HD;
      qv[u] = 0.f;
      if (r < rows) {
        const int s = r / G, h = kh * G + r % G;
        qv[u] = load_f32(q + b * p.q_sb + s * p.q_ss + h * p.q_sh + d);
      }
    }
    int kp, ks;
    window_load(0, kp, ks);
    const int qp = tid < rows ? p.qpos[b * p.S + tid / G] : 0;
    const int qsg = (tid < rows && p.qseg) ? p.qseg[b * p.S + tid / G] : 0;
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      const int i = tid + kThreads * u;
      if (i < MAXR * HD) qs[(i / HD) * LDQ + i % HD] = qv[u] * p.scale;
    }
    kpos_w[tid] = kp;
    kseg_w[tid] = ks;
    if (tid < MAXR) {
      qpos_s[tid] = qp;
      qseg_s[tid] = qsg;
      ms[tid] = kNegInf;
      ls[tid] = 0.f;
    }
  }

  // this thread's outputs: row r, dims 4 * d4 .. + 3 of o = tid + 256 u
  float acc[OPT][4];
#pragma unroll
  for (int u = 0; u < OPT; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;

  for (int j = 0; j < my_tiles; ++j) {
    const int jw = j % kDecodeWin;
    if (j > 0 && jw == 0) {  // the next window of positions
      int kp, ks;
      window_load(j, kp, ks);
      __syncthreads();  // the previous window is read
      kpos_w[tid] = kp;
      kseg_w[tid] = ks;
    }
    __syncthreads();
    const int* kpt = kpos_w + jw * kDecodeTile;
    const int* kst = kseg_w + jw * kDecodeTile;
    bool any = false;
    for (int i = tid; i < rows * kDecodeTile && !any; i += kThreads) {
      const int r = i / kDecodeTile, c = i % kDecodeTile;
      any = pair_valid(p, qpos_s[r], qseg_s[r], kpt[c], kst[c]);
    }
    if (!__syncthreads_or(any)) continue;  // wholly masked tile

    // K, then V, of the tile: 16-byte copies, zero-filled past T
    const long long t0 = (long long)(split + nsplit * j) * kDecodeTile;
    for (int i = tid; i < kDecodeTile * D::CHUNKS; i += kThreads) {
      const int c = i / D::CHUNKS, e0 = (i % D::CHUNKS) * EC;
      const long long t = t0 + c;
      cp_async16(Ks + c * LDK + e0,
                 t < p.T ? k + b * p.k_sb + t * p.k_st + kh * p.k_sh + e0 : k,
                 t < p.T ? 16 : 0);
    }
    cp_async_commit();
    for (int i = tid; i < kDecodeTile * D::CHUNKS; i += kThreads) {
      const int c = i / D::CHUNKS, e0 = (i % D::CHUNKS) * EC;
      const long long t = t0 + c;
      cp_async16(Vs + c * LDK + e0,
                 t < p.T ? v + b * p.v_sb + t * p.v_st + kh * p.v_sh + e0 : v,
                 t < p.T ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<1>();  // K has landed (V may still be in flight)
    __syncthreads();

    // scores: a thread a (row, key) pair, the dot in d order
#pragma unroll
    for (int u = 0; u < PPT; ++u) {
      const int i = tid + kThreads * u, r = i / kDecodeTile;
      const int c = i % kDecodeTile;
      if (r >= rows) continue;
      const float* qr = qs + r * LDQ;
      const T* kr = Ks + c * LDK;
      float x = 0.f;
#pragma unroll 2
      for (int d0 = 0; d0 < HD; d0 += 4) {
        float qf[4], kf[4];
        ldv<4>(qr + d0, qf);
        ldv<4>(kr + d0, kf);
#pragma unroll
        for (int e = 0; e < 4; ++e) x = fmaf(qf[e], kf[e], x);
      }
      if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      Ps[r * LDS + c] =
          pair_valid(p, qpos_s[r], qseg_s[r], kpt[c], kst[c]) ? x : kNegInf;
    }
    __syncthreads();

    // online softmax: a warp a row, two keys a lane
    for (int r = warp; r < rows; r += kWarps) {
      const float s0 = Ps[r * LDS + lane], s1 = Ps[r * LDS + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      Ps[r * LDS + lane] = p0;
      Ps[r * LDS + lane + 32] = p1;
      __syncwarp();  // every lane has read m
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        ms[r] = m_new;
        ls[r] = fmaf(ls[r], corr, sum);
        cs[r] = corr;
      }
    }
    cp_async_wait<0>();  // V has landed
    __syncthreads();

    // P . V: a thread 4 dims of a row, the keys in order
#pragma unroll
    for (int u = 0; u < OPT; ++u) {
      const int o = tid + kThreads * u, r = o / (HD / 4);
      const int d = 4 * (o % (HD / 4));
      if (r >= rows) continue;
      const float corr = cs[r];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][e] = __fmul_rn(acc[u][e], corr);
#pragma unroll 2
      for (int c0 = 0; c0 < kDecodeTile; c0 += 4) {
        float pf[4];
        ldv<4>(Ps + r * LDS + c0, pf);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float vf[4];
          ldv<4>(Vs + (c0 + c) * LDK + d, vf);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[u][e] = fmaf(pf[c], vf[e], acc[u][e]);
        }
      }
    }
    __syncthreads();  // K, V and P are free again
  }

  // the block's partial: (ms, ls) and acc into shared memory
#pragma unroll
  for (int u = 0; u < OPT; ++u) {
    const int o = tid + kThreads * u, r = o / (HD / 4);
    const int d = 4 * (o % (HD / 4));
    if (r < rows)
      *reinterpret_cast<float4*>(bacc + r * HD + d) =
          make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
  }

  // the cluster's: rank 0 merges the blocks' partials in rank order
  odc_cluster_sync();
  if (split == 0) {
    for (int r = tid; r < rows; r += kThreads) {
      float M = kNegInf;
      for (int x = 0; x < nsplit; ++x) M = fmaxf(M, ld_cluster(ms + r, x));
      float L = 0.f;
      for (int x = 0; x < nsplit; ++x) {
        const float f = expf(ld_cluster(ms + r, x) - M);
        fac[r * kSplit + x] = f;
        L = fmaf(ld_cluster(ls + r, x), f, L);
      }
      Ls[r] = fmaxf(L, 1e-30f);
    }
    __syncthreads();
    for (int i = tid; i < rows * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, s = r / G, h = kh * G + r % G;
      float a = 0.f;
      for (int x = 0; x < nsplit; ++x)
        a = fmaf(ld_cluster(bacc + i, x), fac[r * kSplit + x], a);
      store_f32(out + b * p.o_sb + s * p.o_ss + h * p.o_sh + d, a / Ls[r]);
    }
  }
  odc_cluster_sync();  // no block leaves while rank 0 reads it
}

// ===========================================================================
// launch
// ===========================================================================
// The launch shape of one call, for the wrapper's plan and the launch.
struct Plan {
  int decode;      // 1: attn_decode, 0: the tiled loop
  dim3 grid;
  int threads;
  size_t smem;
  int cluster;     // blocks of a cluster
  int rows_tile;   // BQ, or the decode instantiation's MAXR
  int keys_tile;   // BK, or the decode tile
};

template <typename K>
cudaError_t set_smem(K kernel, size_t smem, bool& done) {
  if (done) return cudaSuccess;  // once per instantiation
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  done = e == cudaSuccess;
  return e;
}

template <typename T, int HD, int BQ, int BK, bool STATE>
cudaError_t launch_tiled(const Params& p, cudaStream_t stream, Plan* plan) {
  constexpr size_t smem = Tiled<T, HD, BQ, BK>::smem;
  const int rows = p.S * (p.H / p.KH);
  const dim3 grid((rows + BQ - 1) / BQ, p.KH, p.B);
  if (plan) {
    *plan = Plan{0, grid, kThreads, smem, 1, BQ, BK};
    return cudaSuccess;
  }
  void (*kernel)(Params) =
      STATE ? attn_state<T, HD, BQ, BK> : attn_fwd<T, HD, BQ, BK>;
  static bool smem_set = false;
  const cudaError_t e = set_smem(kernel, smem, smem_set);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD, int MAXR>
cudaError_t launch_decode(const Params& p, cudaStream_t stream, Plan* plan) {
  constexpr size_t smem = Decode<T, HD, MAXR>::smem;
  const int nsplit = decode_split(p.KH);
  const dim3 grid(nsplit, p.KH, p.B);
  if (plan) {
    *plan = Plan{1, grid, kThreads, smem, nsplit, MAXR, kDecodeTile};
    return cudaSuccess;
  }
  static bool smem_set = false;
  const cudaError_t e = set_smem(attn_decode<T, HD, MAXR>, smem, smem_set);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = nsplit;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, attn_decode<T, HD, MAXR>, p);
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  return err != cudaSuccess ? err : last;
}

template <typename T, int HD>
cudaError_t dispatch_decode(const Params& p, cudaStream_t stream,
                            Plan* plan) {
  const int rows = p.S * (p.H / p.KH);
  if (rows <= 2) return launch_decode<T, HD, 2>(p, stream, plan);
  if (rows <= 8) return launch_decode<T, HD, 8>(p, stream, plan);
  if constexpr (decode_rows(HD) > 8)
    return launch_decode<T, HD, 16>(p, stream, plan);
  return cudaErrorInvalidValue;
}

// Tiles per head dim (see the note at the top): BK divides 64, so a
// state sweep over chunks of a multiple of 64 keys reproduces attn_fwd
// bit for bit.
template <typename T, bool STATE>
cudaError_t dispatch(const Params& p, int hd, cudaStream_t stream,
                     Plan* plan) {
  const bool decode = !STATE && p.S * (p.H / p.KH) <= decode_rows(hd);
  switch (hd) {
    case 32:
      return decode ? dispatch_decode<T, 32>(p, stream, plan)
                    : launch_tiled<T, 32, 64, 64, STATE>(p, stream, plan);
    case 64:
      return decode ? dispatch_decode<T, 64>(p, stream, plan)
                    : launch_tiled<T, 64, 64, 64, STATE>(p, stream, plan);
    case 128:
      return decode ? dispatch_decode<T, 128>(p, stream, plan)
                    : launch_tiled<T, 128, 64, 32, STATE>(p, stream, plan);
    case 256:
      return decode ? dispatch_decode<T, 256>(p, stream, plan)
                    : launch_tiled<T, 256, 64, 32, STATE>(p, stream, plan);
    default: return cudaErrorInvalidValue;
  }
}

template <bool STATE>
int run(const Params& p, int hd, int dtype, void* stream,
        Plan* plan = nullptr) {
  if (p.B <= 0 || p.S <= 0 || p.T <= 0 || p.KH <= 0 || p.H % p.KH != 0)
    return cudaErrorInvalidValue;
  // Both paths read K/V rows in 16-byte pieces: every row must start on 16
  // bytes (the wrapper copies a tensor whose rows do not).
  const long long vec = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  if (reinterpret_cast<uintptr_t>(p.k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(p.v) % 16 != 0 || p.k_sb % vec != 0 ||
      p.k_st % vec != 0 || p.k_sh % vec != 0 || p.v_sb % vec != 0 ||
      p.v_st % vec != 0 || p.v_sh % vec != 0)
    return cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float, STATE>(p, hd, st, plan);
  if (dtype == 1) return dispatch<__nv_bfloat16, STATE>(p, hd, st, plan);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head
// dim of q, k, v and out is contiguous, and k and v rows start on 16
// bytes (else cudaErrorMisalignedAddress, before any launch).  Takes the
// decode path when S * (H / KH) <= 16 (8 at head dim 256), else the
// tiled loop.  Returns cudaGetLastError() after the launch (or the error
// that kept it from launching).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, const void* qpos,
    const void* kpos, const void* qseg, const void* kseg, int B, int S, int T,
    int H, int KH, int hd, int dtype, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, float softcap,
    float scale, void* stream) {
  Params p{q, k, v, out, nullptr, nullptr, nullptr,
           static_cast<const int*>(qpos), static_cast<const int*>(kpos),
           static_cast<const int*>(qseg), static_cast<const int*>(kseg),
           B, S, T, H, KH,
           q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
           o_sb, o_ss, o_sh,
           causal, window, softcap, scale};
  return run<false>(p, hd, dtype, stream);
}

// One online-softmax sweep of q over a kv chunk: the carry m, l (B, S, H)
// and acc (B, S, H, hd), float32 and contiguous, is read and written in
// place (see the note at the top).  Arguments as repro_flash_attention_fwd
// without the output.  Always the tiled loop.
extern "C" int repro_flash_attention_state(
    const void* q, const void* k, const void* v, void* m, void* l,
    void* acc, const void* qpos, const void* kpos, const void* qseg,
    const void* kseg, int B, int S, int T, int H, int KH, int hd, int dtype,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, int causal, int window, float softcap, float scale,
    void* stream) {
  Params p{q, k, v, nullptr, static_cast<float*>(m), static_cast<float*>(l),
           static_cast<float*>(acc),
           static_cast<const int*>(qpos), static_cast<const int*>(kpos),
           static_cast<const int*>(qseg), static_cast<const int*>(kseg),
           B, S, T, H, KH,
           q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
           0, 0, 0,
           causal, window, softcap, scale};
  return run<true>(p, hd, dtype, stream);
}

// The launch shape a call of these shapes gets, launching nothing: out =
// {decode path (1) or tiled (0), grid x, y, z, threads, dynamic shared
// memory bytes, cluster size, rows of a tile (BQ, or the decode
// instantiation's MAXR), keys of a tile}.  state: the state sweep.
extern "C" int repro_flash_attention_plan(int B, int S, int T, int H, int KH,
                                          int hd, int dtype, int state,
                                          int* out) {
  Params p{};
  p.B = B; p.S = S; p.T = T; p.H = H; p.KH = KH;
  Plan plan{};
  const int e = state ? run<true>(p, hd, dtype, nullptr, &plan)
                      : run<false>(p, hd, dtype, nullptr, &plan);
  if (e != cudaSuccess) return e;
  const int vals[9] = {plan.decode, int(plan.grid.x), int(plan.grid.y),
                       int(plan.grid.z), plan.threads, int(plan.smem),
                       plan.cluster, plan.rows_tile, plan.keys_tile};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return cudaSuccess;
}
