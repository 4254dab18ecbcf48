// ODC gather fused with the consumer matmul (collective matmul) for
// Hopper (sm_90a), hand-written CUDA C++: a tensor-core route for bf16 and
// a register-tiled CUDA-core route for f32 and for what TMA cannot take.
//
// Replaces: src/repro/kernels/gather_matmul.py::gather_matmul_pallas (the
// pallas_call at :92, body _gather_matmul_kernel :27).  Same function
// (ops.gather_matmul), for every rank of a ring at once: rank r holds x_r
// (m, k) and the r-th (c, f) row shard of W (k = n * c); it gets
//   out_r = sum_{i = 0 .. n-1} x_r[:, s_i*c : (s_i+1)*c] @ shard_{s_i},
//   s_i = (r - i) mod n,
// the TPU kernel's hop order (:62-66): on hop i rank r multiplies the
// shard that has travelled i hops to it.  Every product is summed in f32
// and the total is rounded to the output type (x's) once, at the end.
// The full W never exists.
//
// Summation order: a block keeps one f32 accumulator per output element
// for the whole call and walks the hops in the order above, each hop's c
// rows in k steps; so within a hop the terms are summed in another order
// than the plain version's (gather_matmul_plain: one product per hop,
// then a per-hop total), and no separate per-hop sum exists (a
// tensor-core tile cannot hold a second total).  Both sum the same exact
// products (bf16 x bf16 is exact in f32) in f32.
//
// What has no counterpart here: the TPU kernel's two staging slots, its
// DMA semaphores and the credit back-pressure (:36-77) guard a VMEM slot
// that the left neighbour overwrites while this device still multiplies
// it.  Every rank of this version lies on one card, so each shard stays
// where its owner holds it, read-only for the whole call, and each block
// reads shard s_i there through the per-rank tables: there is nothing in
// flight to guard.  Across cards, that read is the on-demand pull of the
// peer-pointer route (ROADMAP queue 1 item 9): a block reads the owner's
// shard over NVLink through a peer pointer, with no staging copy.
//
// Route (a pure function of the shapes, the type and the pointers'
// alignment, decided by the wrapper before launch; gather_matmul.py::
// launch_plan): bf16 whose rows TMA can address (c and f multiples of 8
// elements, so that x's, the shards' and the outputs' rows are multiples
// of 16 bytes; every pointer 16-byte aligned) takes the tensor-core route;
// everything else, f32 included, the CUDA-core route.
//
// Tensor-core route (gm_tc_kernel, bf16 in, f32 accumulate, bf16 out).
// What bounds it: the operations, 2 m k f per rank at 989 TFLOP/s; the
// bytes are about 1/200 of that time.  Design: a block owns a 128 x 256
// output tile of one rank (grid: m tiles, f tiles, ranks) and runs 3
// warpgroups.  Warpgroup 2 is the producer: one thread keeps TMA tile
// loads (cp.async.bulk.tensor, 128-byte swizzle) in flight into a ring of
// 4 stages, each guarded by a full and an empty mbarrier; a stage holds
// x's (128, 64) slice and the shard's (64, 256) slice (4 boxes of 64
// columns; a box wholly past f is not loaded: its columns are never
// stored).  Warpgroups 0 and 1 are the consumers, rows 0-63 and 64-127:
// each issues wgmma.mma_async m64n256k16 (A K-major from x's slice, B the
// shard slice read N-major with the transpose bit, since the shard is
// (c, f) row-major), keeps one stage's products in flight
// (wgmma.wait_group 1) and releases the stage before it.  setmaxnreg moves
// registers from the producer (40) to the consumers (232: 128 accumulators
// a thread).  The epilogue rounds to bf16 and stores the tile, masked at
// the m and f edges (zamba2's in_proj has f = 8384, not a multiple of 256),
// staged through shared memory so that each row leaves in 16-byte pieces
// (storing the fragments directly measured slower, PERF.md).  The
// grid walks the m tiles first, so that the blocks resident at once
// share a few column blocks of the shard and the shards are read from
// device memory about once (f tiles first re-read every shard each wave).
// The k loop walks hop after hop; each hop walks its shard's c rows in
// steps of 64.  x is viewed as a 3-D tensor (m, n, c), so the box of hop s
// is zero-filled past column c of shard s instead of reading the next
// shard's columns (a zero-filled shard row would not do: 0 * inf is NaN).
// The 2n tensor maps (x of each rank, each shard; up to 4 KB) are kernel
// parameters (__grid_constant__), which needs CUDA >= 12.1's 32 KB
// parameter space; the encoder (cuTensorMapEncodeTiled) is reached through
// cudaGetDriverEntryPoint, so the library links no driver library.
// What it leaves on the table: a persistent grid with two consumer
// warpgroups on different tiles (one's epilogue under the other's
// products), and TMA multicast of shared slices across a cluster.
//
// CUDA-core route (gm_simt_kernel): f32 (TF32 would break the f32
// tolerance), and bf16 shapes that TMA cannot take, in bf16 in and out.
// What bounds it: the operations at the CUDA cores' 67 TFLOP/s.  Design: a
// 128 x 128 block tile over 256 threads (grid: m tiles, f tiles, ranks, as
// above), each thread an 8 x 8 register tile (rows 4ty..+3 and
// 64+4ty..+3, columns 4tx..+3 and 64+4tx..+3, so that a warp's
// shared-memory reads are conflict-free float4s: two broadcast addresses
// of x's slice and 16 consecutive float4s of the shard's); k steps of 16,
// double-buffered: the shard's (16, 128) slice arrives by cp.async in
// 16-byte copies, x's (128, 16) slice by float4 loads into registers
// while the current step computes, then stored transposed (register-
// staged: a 16-byte cp.async cannot transpose).  Shapes or pointers that
// are not 16-byte aligned, and bf16, take the same kernel through a
// guarded scalar load path (each element converted to f32 as it is
// staged).  Two blocks an SM, 128 registers a thread.  What holds it
// back: it runs at about 62% of the f32 peak and behind cuBLAS's SGEMM
// (PERF.md); k steps of 8, 16 and 32, 2-4 cp.async stages (x by 4-byte
// copies into its transposed place), warp-tiled thread layouts and one
// block an SM all measured no faster, so the loop's instruction schedule
// is what is left; 3xTF32 on the tensor cores is a later option with its
// own tolerance (ROADMAP).
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#if CUDART_VERSION < 12010
#error "gm_tc_kernel takes up to 4 KB of tensor maps as parameters: CUDA >= 12.1"
#endif

namespace {

constexpr int kMaxRanks = 16;

// ---------------------------------------------------------------------------
// tensor-core route
// ---------------------------------------------------------------------------
constexpr int kTcBM = 128, kTcBN = 256, kTcBK = 64, kTcStages = 4;
constexpr int kTcThreads = 384;  // consumers 0-255, producer 256-383
constexpr int kTcABytes = kTcBM * kTcBK * 2;           // x's slice
constexpr int kTcBoxBytes = kTcBK * 64 * 2;            // one 64-column box
constexpr int kTcBBytes = kTcBoxBytes * (kTcBN / 64);  // the shard's slice
constexpr int kTcStageBytes = kTcABytes + kTcBBytes;
// the stages (1024-byte aligned for the swizzle), a full and an empty
// barrier each, and the slack to align the base
constexpr int kTcSmemBytes = kTcStages * kTcStageBytes + kTcStages * 16 + 1024;

struct TcParams {
  CUtensorMap x[kMaxRanks];  // rank r's x as (m, n, c)
  CUtensorMap w[kMaxRanks];  // shard s, (c, f)
  void* out[kMaxRanks];      // rank r's (m, f)
  int n, m, c, f;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t gm_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d[128] += A (64 x 16, K-major) . B (16 x 256, N-major: transpose bit)
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void gm_fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(kTcThreads, 1)
gm_tc_kernel(const __grid_constant__ TcParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kTcStages * kTcStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kTcStages + s); };
  auto stage_a = [&](int s) { return base + (uint32_t)(s * kTcStageBytes); };
  auto stage_b = [&](int s) { return stage_a(s) + kTcABytes; };

  const int r = blockIdx.z;
  const int row0 = blockIdx.x * kTcBM, col0 = blockIdx.y * kTcBN;
  const int n = p.n, c = p.c;
  const int ksteps = (c + kTcBK - 1) / kTcBK;
  const int total = n * ksteps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int boxes = (p.f - col0 + 63) / 64;
      if (boxes > kTcBN / 64) boxes = kTcBN / 64;
      const uint32_t bytes = kTcABytes + boxes * kTcBoxBytes;
      for (int t = 0; t < total; ++t) {
        const int s = t % kTcStages;
        mbar_wait(empty(s), ((t / kTcStages) & 1) ^ 1);
        mbar_expect_tx(full(s), bytes);
        const int hop = t / ksteps, kk = (t % ksteps) * kTcBK;
        const int shard = ((r - hop) % n + n) % n;
        tma_load_3d(stage_a(s), &p.x[r], full(s), kk, shard, row0);
        for (int q = 0; q < boxes; ++q)
          tma_load_2d(stage_b(s) + q * kTcBoxBytes, &p.w[shard], full(s),
                      col0 + 64 * q, kk);
      }
    }
  } else {
    // consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    for (int t = 0; t < total; ++t) {
      const int s = t % kTcStages;
      mbar_wait(full(s), (t / kTcStages) & 1);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kq = 0; kq < kTcBK / 16; ++kq) {
        // A: x's rows 64 wg.., 16 columns (32 bytes) further each step;
        // rows are 128 bytes, 8-row groups 1024 bytes apart
        const uint64_t da =
            gm_desc(stage_a(s) + wg * 64 * 128 + kq * 32, 16, 1024);
        // B: the shard's rows kk + 16 kq.., 128 bytes each; 64-column
        // boxes 8 KB apart (leading), 8-row groups 1024 bytes apart
        const uint64_t db =
            gm_desc(stage_b(s) + kq * 16 * 128, kTcBoxBytes, 1024);
        wgmma_m64n256k16(d, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      gm_fence_acc(d);
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      gm_fence_acc(d);
      if (t > 0) mbar_arrive(empty((t - 1) % kTcStages));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    gm_fence_acc(d);

    // epilogue: d[4i + 2h + e] is row 16 warp + lane/4 + 8h, column
    // 8i + 2 (lane % 4) + e of the warpgroup's 64 x 256 tile.  Once both
    // warpgroups are done reading the stages (wait_group 0, then a
    // barrier of the 256 consumer threads; every load has landed, since
    // each was waited for), each stages its tile, rounded to bf16, in
    // the stages' shared memory, rows padded by 16 bytes so that the
    // fragment writes hit distinct banks, then writes it out a row at a
    // time in 16-byte pieces (the fragments themselves would make 4-byte
    // stores of 16 bytes a row).
    asm volatile("bar.sync 1, 256;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const int t128 = threadIdx.x % 128, warp = t128 / 32, lane = t128 % 32;
    constexpr int kRowBytes = kTcBN * 2 + 16;
    uint8_t* tile =
        smem_raw + (base - smem_u32(smem_raw)) + wg * 64 * kRowBytes;
#pragma unroll
    for (int i = 0; i < kTcBN / 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = warp * 16 + lane / 4 + 8 * h;
        const int col = 8 * i + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(tile + row * kRowBytes + col * 2) =
            __floats2bfloat162_rn(d[4 * i + 2 * h], d[4 * i + 2 * h + 1]);
      }
    }
    asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out[r]);
    constexpr int kPieces = kTcBN / 8;  // 16-byte pieces of a row
#pragma unroll 4
    for (int e = t128; e < 64 * kPieces; e += 128) {
      const int row = e / kPieces, piece = e % kPieces;
      const int grow = row0 + wg * 64 + row, gcol = col0 + piece * 8;
      // f is a multiple of 8 on this route: a piece is in or out whole
      if (grow < p.m && gcol < p.f)
        *reinterpret_cast<uint4*>(out + (long long)grow * p.f + gcol) =
            *reinterpret_cast<const uint4*>(tile + row * kRowBytes +
                                            piece * 16);
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA-core route
// ---------------------------------------------------------------------------
constexpr int kSimtBM = 128, kSimtBN = 128, kSimtBK = 16, kSimtPad = 4;
constexpr int kSimtThreads = 256;
constexpr int kSimtMinBlocks = 2;  // blocks an SM holds: 128 registers each
// static shared memory of a block
constexpr int kSimtSmemBytes =
    (int)sizeof(float) * 2 * kSimtBK * (kSimtBM + kSimtPad + kSimtBN);

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// kVec: float32 with c and f multiples of 4 and 16-byte aligned pointers
// (float4 loads of x, cp.async of the shard, float4 stores); otherwise
// every element is loaded, converted and stored alone, guarded.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kSimtThreads, kSimtMinBlocks)
gm_simt_kernel(Ranks ranks, int n, int m, int k, int f) {
  // two stages of x's slice (transposed) and the shard's
  __shared__ __align__(16) float xs[2][kSimtBK][kSimtBM + kSimtPad];
  __shared__ __align__(16) float ws[2][kSimtBK][kSimtBN];

  const int r = blockIdx.z;
  const int row0 = blockIdx.x * kSimtBM, col0 = blockIdx.y * kSimtBN;
  const int c = k / n;
  // each thread's 8 x 8 tile: rows ra.. and ra + kSimtBM / 2..,
  // columns cb.. and cb + kSimtBN / 2.., 4 of each
  const int tid = threadIdx.x;
  const int ra = 4 * (tid / (kSimtBN / 8)), cb = 4 * (tid % (kSimtBN / 8));
  constexpr int kRa = kSimtBM / 2, kCb = kSimtBN / 2;
  const T* x = static_cast<const T*>(ranks.x[r]);
  const int ksteps = (c + kSimtBK - 1) / kSimtBK, total = n * ksteps;

  // staging: each thread holds kXLoads (row, 4 columns) pieces of x's
  // slice and, on the scalar path, kWLoads of the shard's
  constexpr int kXLoads = kSimtBM * kSimtBK / (4 * kSimtThreads);
  constexpr int kWLoads = kSimtBK * kSimtBN / (4 * kSimtThreads);
  float xr[kXLoads][4], wr[kWLoads][4];

  auto tile = [&](int t, int* shard, int* kk) {
    const int hop = t / ksteps;
    *shard = ((r - hop) % n + n) % n;
    *kk = (t % ksteps) * kSimtBK;
  };
  // x's slice (and, on the scalar path, the shard's) into registers
  auto load = [&](int t) {
    int s, kk;
    tile(t, &s, &kk);
    const long long xcol = (long long)s * c;
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int idx = tid + kSimtThreads * i;
      const int row = row0 + idx / (kSimtBK / 4);
      const int col = kk + (idx % (kSimtBK / 4)) * 4;
      const T* src = x + (long long)row * k + xcol + col;
      if constexpr (kVec) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < m && col < c) v = __ldg(reinterpret_cast<const float4*>(src));
        xr[i][0] = v.x; xr[i][1] = v.y; xr[i][2] = v.z; xr[i][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          xr[i][j] = (row < m && col + j < c) ? to_f32<T>(src[j]) : 0.f;
      }
    }
    if constexpr (!kVec) {
      const T* w = static_cast<const T*>(ranks.w[s]);
#pragma unroll
      for (int i = 0; i < kWLoads; ++i) {
        const int idx = tid + kSimtThreads * i;
        const int kr = kk + idx / (kSimtBN / 4);
        const int col = col0 + (idx % (kSimtBN / 4)) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wr[i][j] = (kr < c && col + j < f)
                         ? to_f32<T>(w[(long long)kr * f + col + j]) : 0.f;
      }
    }
  };
  // the shard's slice by cp.async (kVec), zero-filled past c and f
  auto load_w_async = [&](int t, int buf) {
    int s, kk;
    tile(t, &s, &kk);
    const float* w = static_cast<const float*>(ranks.w[s]);
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int idx = tid + kSimtThreads * i;
      const int kr = idx / (kSimtBN / 4), cq = (idx % (kSimtBN / 4)) * 4;
      const bool ok = kk + kr < c && col0 + cq < f;
      cp_async16(&ws[buf][kr][cq],
                 ok ? w + (long long)(kk + kr) * f + col0 + cq : w,
                 ok ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  // x's slice stored transposed (rows of a warp on distinct banks)
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int idx = tid + kSimtThreads * i;
      const int row = idx / (kSimtBK / 4), kq = (idx % (kSimtBK / 4)) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) xs[buf][kq + j][row] = xr[i][j];
    }
    if constexpr (!kVec) {
#pragma unroll
      for (int i = 0; i < kWLoads; ++i) {
        const int idx = tid + kSimtThreads * i;
        const int kr = idx / (kSimtBN / 4), cq = (idx % (kSimtBN / 4)) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) ws[buf][kr][cq + j] = wr[i][j];
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  if constexpr (kVec) load_w_async(0, 0);
  store(0);
  if constexpr (kVec) asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  for (int t = 0; t < total; ++t) {
    const int buf = t & 1;
    const bool next = t + 1 < total;
    if (next) {
      load(t + 1);
      if constexpr (kVec) load_w_async(t + 1, buf ^ 1);
    }
#pragma unroll
    for (int kq = 0; kq < kSimtBK; ++kq) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[buf][kq][ra]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[buf][kq][ra + kRa]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[buf][kq][cb]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[buf][kq][cb + kCb]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (next) {
      store(buf ^ 1);
      if constexpr (kVec) asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
  }

  T* out = static_cast<T*>(ranks.out[r]);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + ra + (i < 4 ? i : kRa + i - 4);
    if (row >= m) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = col0 + cb + kCb * half;
      T* dst = out + (long long)row * f + col;
      if constexpr (kVec) {
        if (col < f)
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[i][4 * half], acc[i][4 * half + 1],
                          acc[i][4 * half + 2], acc[i][4 * half + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < f) dst[j] = from_f32<T>(acc[i][4 * half + j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

bool aligned16(const void* const* ptrs, int n) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) & 15) return false;
  return true;
}

// the shapes either route takes at all
bool shapes_ok(int n, int m, int k, int f) {
  return n >= 1 && n <= kMaxRanks && m >= 1 && f >= 1 && k >= n &&
         k % n == 0 && (f + kSimtBN - 1) / kSimtBN <= 65535;
}

// the tensor-core route's own rule (besides 16-byte aligned pointers):
// bf16, rows of x, the shards and the outputs multiples of 16 bytes
bool tc_ok(int n, int k, int f, int dtype) {
  return dtype == 1 && (k / n) % 8 == 0 && f % 8 == 0;
}

}  // namespace

// The launch of a route (0: tensor cores, 1: CUDA cores) for these
// shapes and dtype (0 float32, 1 bfloat16), `aligned`: every pointer is
// 16-byte aligned.  plan[0..5] = grid x, y, z, threads, shared memory
// bytes of a block, and the load path (0 TMA, 1 cp.async and float4,
// 2 scalar).  Returns cudaErrorInvalidValue for what the route does not
// take.
extern "C" int repro_gather_matmul_plan(int n, int m, int k, int f,
                                        int dtype, int route, int aligned,
                                        int* plan) {
  if (!shapes_ok(n, m, k, f) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (route == 0) {
    if (!aligned || !tc_ok(n, k, f, dtype)) return cudaErrorInvalidValue;
    plan[0] = (m + kTcBM - 1) / kTcBM;
    plan[1] = (f + kTcBN - 1) / kTcBN;
    plan[2] = n;
    plan[3] = kTcThreads;
    plan[4] = kTcSmemBytes;
    plan[5] = 0;
    return 0;
  }
  if (route != 1) return cudaErrorInvalidValue;
  const int c = k / n;
  plan[0] = (m + kSimtBM - 1) / kSimtBM;
  plan[1] = (f + kSimtBN - 1) / kSimtBN;
  plan[2] = n;
  plan[3] = kSimtThreads;
  plan[4] = kSimtSmemBytes;
  plan[5] = (dtype == 0 && aligned && c % 4 == 0 && f % 4 == 0) ? 1 : 2;
  return 0;
}

// xs, ws, outs: host arrays of n device pointers (rank r's x (m, k), its
// (k / n, f) row shard of W, its (m, f) output), all bfloat16.  The
// tensor-core route; returns the CUDA error of the launch
// (cudaErrorInvalidValue for arguments it does not take, a driver error
// code + 10000 when a tensor map cannot be encoded).
extern "C" int repro_gather_matmul_tc(const void* const* xs,
                                      const void* const* ws,
                                      void* const* outs, int n, int m, int k,
                                      int f, void* stream) {
  if (!shapes_ok(n, m, k, f) || !tc_ok(n, k, f, 1) || !aligned16(xs, n) ||
      !aligned16(ws, n) || !aligned16(outs, n))
    return cudaErrorInvalidValue;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int c = k / n;
  TcParams p = {};
  p.n = n;
  p.m = m;
  p.c = c;
  p.f = f;
  for (int r = 0; r < n; ++r) {
    const cuuint64_t xdim[3] = {(cuuint64_t)c, (cuuint64_t)n, (cuuint64_t)m};
    const cuuint64_t xstride[2] = {(cuuint64_t)c * 2, (cuuint64_t)k * 2};
    const cuuint32_t xbox[3] = {kTcBK, 1, kTcBM};
    const cuuint32_t ones[3] = {1, 1, 1};
    CUresult e = encode(&p.x[r], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(xs[r]), xdim, xstride, xbox, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (e != CUDA_SUCCESS) return 10000 + (int)e;
    const cuuint64_t wdim[2] = {(cuuint64_t)f, (cuuint64_t)c};
    const cuuint64_t wstride[1] = {(cuuint64_t)f * 2};
    const cuuint32_t wbox[2] = {64, kTcBK};
    e = encode(&p.w[r], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
               const_cast<void*>(ws[r]), wdim, wstride, wbox, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (e != CUDA_SUCCESS) return 10000 + (int)e;
    p.out[r] = outs[r];
  }
  cudaError_t err = cudaFuncSetAttribute(
      gm_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTcSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((m + kTcBM - 1) / kTcBM, (f + kTcBN - 1) / kTcBN, n);
  gm_tc_kernel<<<grid, kTcThreads, kTcSmemBytes,
                 static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// The CUDA-core route, dtype 0 float32 or 1 bfloat16 (x, the shards and
// the outputs share it); the float4 / cp.async loads when the shapes and
// pointers allow them, else the scalar loads.  Returns the CUDA error of
// the launch (cudaErrorInvalidValue for arguments it does not take).
extern "C" int repro_gather_matmul_simt(const void* const* xs,
                                        const void* const* ws,
                                        void* const* outs, int n, int m,
                                        int k, int f, int dtype,
                                        void* stream) {
  if (!shapes_ok(n, m, k, f) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  Ranks ranks = {};
  for (int r = 0; r < n; ++r) {
    ranks.x[r] = xs[r];
    ranks.w[r] = ws[r];
    ranks.out[r] = outs[r];
  }
  const int c = k / n;
  const bool vec = dtype == 0 && c % 4 == 0 && f % 4 == 0 &&
                   aligned16(xs, n) && aligned16(ws, n) && aligned16(outs, n);
  dim3 grid((m + kSimtBM - 1) / kSimtBM, (f + kSimtBN - 1) / kSimtBN, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    gm_simt_kernel<float, true><<<grid, kSimtThreads, 0, st>>>(ranks, n, m,
                                                                k, f);
  else if (dtype == 0)
    gm_simt_kernel<float, false><<<grid, kSimtThreads, 0, st>>>(ranks, n, m,
                                                                 k, f);
  else
    gm_simt_kernel<__nv_bfloat16, false>
        <<<grid, kSimtThreads, 0, st>>>(ranks, n, m, k, f);
  return cudaGetLastError();
}
