// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (the pallas_call at :167, body _attn_kernel :62 / _attn_update :26).
// Same function and numerics: q is pre-scaled in f32, the soft cap
// cap*tanh(s/cap) is applied before masking, the mask is
//   kp >= 0  &&  (!causal || rel >= 0)  &&  (window <= 0 || rel < window)
//            &&  q_segment == kv_segment,          rel = q_pos - kv_pos,
// masked scores take the finite NEG_INF = -2e38 (never -inf), the online
// softmax state (m, l, acc) is kept in f32, and the output is
// acc / max(l, 1e-30) rounded to the input type.  GQA maps q head h to
// kv head h / G.
//
// Design.  The TPU kernel walks a sequential grid (B*H, q-blocks,
// kv-blocks) and carries (m, l, acc) in VMEM scratch from one kv step to
// the next.  Here each thread block owns one (batch, kv head, query tile)
// and loops over kv tiles itself.  The tile's rows are the flattened
// (query position, head-in-group) pairs of one kv head, so the G query
// heads that share a kv head read each K/V tile once (qwen: G = 6, so a
// decode step fills 6 rows of a tile instead of 1).  K and V tiles are
// staged in shared memory as f32; each row is owned by TPR neighbouring
// threads that split its score columns and its output dims, and reduce
// the row max and sum with warp shuffles.  The kernel computes its own
// offsets from the strides it is given and masks the ragged S and T edges
// itself instead of padding.  A kv tile in which every (row, column) pair
// is masked is skipped: with finite NEG_INF such a tile is an exact no-op
// on every row that has at least one valid key (corr = 1 and p = 0 once m
// is real, or the junk is wiped by corr = exp(NEG_INF - m) = 0 later), so
// skipping it changes no result.  That makes decode read only the cache
// prefix that has been written, and causal prefill about half of the
// cache.
//
// What bounds it on the H100.  Decode (S = 1): the bytes of K/V read,
// B * valid_T * KH * hd * 2 * sizeof(T), against 3.35 TB/s.  Long prefill:
// the operations, 4 * hd per unmasked (query, key, head) triple, against
// the f32 rate of the CUDA cores (67 TFLOP/s), since the products here
// run on the CUDA cores in f32.
//
// What this simple design leaves on the table: the tensor cores (wgmma
// on bf16 tiles would lift the prefill bound from 67 to 989 TFLOP/s), TMA
// and a multi-stage cp.async/mbarrier pipeline to overlap the K/V loads
// with the math, a split over the kv axis for decode (a decode step has
// only B * KH blocks, 16 at qwen's batch 8, for 132 SMs), and vectorised
// shared-memory access.
//
// The state sweep (repro_flash_attention_state).  Replaces
// src/repro/kernels/flash_attention.py::flash_attention_state (the
// pallas_call at :416, body _attn_state_kernel :85 / _attn_update :26):
// the same tile loop, instantiated with STATE = true, sweeps q over one kv
// *chunk* with the online-softmax state (m, l, acc) entering as a carry
// and leaving unnormalized, all f32, in JAX's layout: m and l (B, S, H),
// acc (B, S, H, hd), contiguous; a row (position s, head-in-group g) of
// kv head kh is carry entry (b, s, h = kh * G + g).  Each block reads its
// own rows' carry before its first tile and writes them after its last,
// and no other block touches those rows, so the carry is updated in
// place: one (m, l, acc) buffer serves every chunk call of a ring
// attention.  The context-parallel ring (core/cp.py) sweeps its chunks in
// ascending global order from a fresh carry (m = NEG_INF, l = acc = 0,
// what attn_fwd starts from); with every chunk a multiple of BK long the
// kv tiles are the monolithic kernel's, and a skipped (wholly masked) tile
// is an exact no-op on every row with a valid key (see above), so
// acc / max(l, 1e-30) of the sweep equals attn_fwd on the gathered
// sequence bit for bit on those rows, however the q rows are grouped into
// blocks.  The update arithmetic is written with explicit fmaf /
// __fmul_rn so that the compiler contracts nothing differently in the two
// instantiations.  Bound: the operations, 4 * hd per unmasked (query,
// key, head) triple at 67 TFLOP/s, plus the carry read and written once
// per chunk (about 50 MB at qwen's 4096 x 12 x 128 local rows, 15 us at
// 3.35 TB/s); that extra round trip per chunk is what this simple design
// adds to attn_fwd's list above.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kThreads = 128;
constexpr int kPadPos = -1000000000;  // kv position of a column past T

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

// Shared memory of one block, in bytes.
template <int HD, int BQ, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * (HD + 1) + 2 * size_t(BK) * (HD + 1) +
                          size_t(BQ) * (BK + 1)) +
         sizeof(int) * (2 * BQ + 2 * BK);
}

template <typename T, int HD, int BQ, int BK, bool STATE>
__device__ __forceinline__ void attn_body(const Params& p) {
  constexpr int TPR = kThreads / BQ;  // threads per query row
  constexpr int DPT = HD / TPR;       // output dims per thread
  constexpr int CPT = BK / TPR;       // score columns per thread
  constexpr int LD = HD + 1;          // odd stride: no bank conflicts
  constexpr int LDP = BK + 1;
  static_assert(kThreads % BQ == 0 && HD % TPR == 0 && BK % TPR == 0, "");
  static_assert(CPT <= 32, "column mask is one 32-bit word");

  extern __shared__ float smem[];
  float* Qs = smem;            // (BQ, LD) pre-scaled q
  float* Ks = Qs + BQ * LD;    // (BK, LD)
  float* Vs = Ks + BK * LD;    // (BK, LD)
  float* Ps = Vs + BK * LD;    // (BQ, LDP) probabilities of this tile
  int* qpos_s = reinterpret_cast<int*>(Ps + BQ * LDP);
  int* qseg_s = qpos_s + BQ;
  int* kpos_s = qseg_s + BQ;
  int* kseg_s = kpos_s + BK;

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* out = static_cast<T*>(p.out);

  const int G = p.H / p.KH;
  const int rows = p.S * G;  // (position, head-in-group) pairs
  const int r0 = blockIdx.x * BQ;
  const int kh = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid / TPR;   // this thread's row of the tile
  const int li = tid % TPR;  // its lane within the row
  const bool row_ok = r0 + r < rows;

  for (int i = tid; i < BQ * HD; i += kThreads) {
    const int rr = i / HD, d = i % HD, row = r0 + rr;
    float x = 0.f;
    if (row < rows) {
      const int s = row / G, h = kh * G + row % G;
      x = load_f32(q + b * p.q_sb + s * p.q_ss + h * p.q_sh + d) * p.scale;
    }
    Qs[rr * LD + d] = x;
  }
  for (int i = tid; i < BQ; i += kThreads) {
    const int row = r0 + i;
    const int s = row < rows ? row / G : 0;
    qpos_s[i] = p.qpos[b * p.S + s];
    qseg_s[i] = p.qseg ? p.qseg[b * p.S + s] : 0;
  }

  float m = kNegInf, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  long long crow = 0;  // this row's carry entry (b, s, h)
  if (row_ok) {
    const int row = r0 + r;
    crow = (b * p.S + row / G) * p.H + kh * G + row % G;
  }
  if (STATE && row_ok) {  // carry in
    m = p.m[crow];
    l = p.l[crow];
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] = p.acc[crow * HD + li + TPR * i];
  }

  const int n_tiles = (p.T + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int t0 = kt * BK;
    __syncthreads();  // the previous tile's Ps/Vs reads are done
    for (int i = tid; i < BK * HD; i += kThreads) {
      const int c = i / HD, d = i % HD, t = t0 + c;
      float kx = 0.f, vx = 0.f;
      if (t < p.T) {
        kx = load_f32(k + b * p.k_sb + t * p.k_st + kh * p.k_sh + d);
        vx = load_f32(v + b * p.v_sb + t * p.v_st + kh * p.v_sh + d);
      }
      Ks[c * LD + d] = kx;
      Vs[c * LD + d] = vx;
    }
    for (int i = tid; i < BK; i += kThreads) {
      const int t = t0 + i;
      kpos_s[i] = t < p.T ? p.kpos[b * p.T + t] : kPadPos;
      kseg_s[i] = (t < p.T && p.kseg) ? p.kseg[b * p.T + t] : 0;
    }
    __syncthreads();

    // the mask of this thread's columns c = li + TPR * j
    unsigned ok = 0u;
    if (row_ok) {
      const int qp = qpos_s[r], qs = qseg_s[r];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = li + TPR * j;
        const int kp = kpos_s[c];
        bool valid = kp >= 0 && qs == kseg_s[c];
        if (valid) {
          const int rel = qp - kp;
          if (p.causal) valid = rel >= 0;
          if (valid && p.window > 0) valid = rel < p.window;
        }
        ok |= unsigned(valid) << j;
      }
    }
    if (!__syncthreads_or(ok != 0u)) continue;  // wholly masked tile

    float s[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qd = Qs[r * LD + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        s[j] = fmaf(qd, Ks[(li + TPR * j) * LD + d], s[j]);
    }

    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      float x = s[j];
      if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      x = ((ok >> j) & 1u) ? x : kNegInf;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float pj = expf(s[j] - m_new);
      sum += pj;
      Ps[r * LDP + li + TPR * j] = pj;
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    l = fmaf(l, corr, sum);
    m = m_new;
    __syncthreads();  // Ps complete

#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] = __fmul_rn(acc[i], corr);
    for (int c = 0; c < BK; ++c) {
      const float pc = Ps[r * LDP + c];
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[i] = fmaf(pc, Vs[c * LD + li + TPR * i], acc[i]);
    }
  }

  if (!row_ok) return;
  if (STATE) {  // carry out, unnormalized
    if (li == 0) {
      p.m[crow] = m;
      p.l[crow] = l;
    }
#pragma unroll
    for (int i = 0; i < DPT; ++i) p.acc[crow * HD + li + TPR * i] = acc[i];
  } else {
    const int row = r0 + r, s = row / G, h = kh * G + row % G;
    const float denom = fmaxf(l, 1e-30f);
    T* o = out + b * p.o_sb + s * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < DPT; ++i) store_f32(o + li + TPR * i, acc[i] / denom);
  }
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) attn_fwd(Params p) {
  attn_body<T, HD, BQ, BK, false>(p);
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) attn_state(Params p) {
  attn_body<T, HD, BQ, BK, true>(p);
}

template <typename T, int HD, int BQ, int BK, bool STATE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, BQ, BK>();
  void (*kernel)(Params) =
      STATE ? attn_state<T, HD, BQ, BK> : attn_fwd<T, HD, BQ, BK>;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int rows = p.S * (p.H / p.KH);
  const dim3 grid((rows + BQ - 1) / BQ, p.KH, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Tile sizes per head dim: at most 64 accumulator floats per thread, and
// shared memory small enough for two or three blocks on an SM.  BK is the
// kv tile: a state sweep's chunks must be multiples of it (64 keys serve
// every head dim) to reproduce attn_fwd bit for bit.
template <typename T, bool STATE>
cudaError_t dispatch(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32, 64, 64, STATE>(p, stream);
    case 64: return launch<T, 64, 64, 64, STATE>(p, stream);
    case 128: return launch<T, 128, 64, 32, STATE>(p, stream);
    case 256: return launch<T, 256, 32, 32, STATE>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool STATE>
int run(const Params& p, int hd, int dtype, void* stream) {
  if (p.B <= 0 || p.S <= 0 || p.T <= 0 || p.KH <= 0 || p.H % p.KH != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float, STATE>(p, hd, st);
  if (dtype == 1) return dispatch<__nv_bfloat16, STATE>(p, hd, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head
// dim of q, k, v and out is contiguous.  Returns cudaGetLastError() after
// the launch (or the error that kept it from launching).
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
// without the output.
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
