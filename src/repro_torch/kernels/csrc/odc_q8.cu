// The compressed (q8) ODC rings of the pipe-int8 backend, every rank of
// the ring on this card: the gather that moves each shard's chunked int8
// encoding, and the ring scatter-accumulate that requantizes its partial
// sum at every hop.
//
// Replaces the TPU kernels repro.kernels.quant.odc_gather_q8_pallas
// (src/repro/kernels/quant.py:137, _gather_q8_kernel at :80) and
// odc_scatter_accumulate_q8_pallas (:242, _scatter_q8_kernel at :174).
// Their hops are two remote DMAs per hop (int8 values, f32 scales) into
// the right neighbour's VMEM slots, sharing one credit.
//
// Gather (repro_odc_gather_q8): rank r's inputs are its shard's codes
// (chunks, 256) int8 and scales (chunks); its outputs (n, chunks, 256) and
// (n, chunks), row s holding rank s's encoding as it left rank s (row r is
// its own).  The wrapper decodes them and writes its own shard back
// exactly.  Like the f32 gather it has no ring: odc_gather_q8_kernel is
// the read-once broadcast of odc_bcast.cuh over two payloads in one plain
// launch, block (b, s) taking whole chunks [lo, hi) of shard s, their
// 256-byte code rows and their scales, so a chunk's scale travels with it.
// Any grid; no staging, flags or residency rule.
//
// Scatter (repro_odc_scatter_q8), one cooperative launch, grid
// (blocks_per_rank, n): a hop is a copy by the sending block into the
// neighbour's staging slot in device memory, signalled by a flag; the
// protocol (flags, credits, epochs, ring order) is odc_ring.cuh's.  The two
// payload streams share one flag and one credit per (slot, block), as the
// TPU kernel's share one credit.  A rank's staging buffer is [q slot 0 | q
// slot 1 | s slot 0 | s slot 1]: chunks * 256 bytes per values slot,
// chunks * 4 per scales slot.  The argument block counts in chunks (elems
// = chunks; odc_args rounds a block's share to 8 chunks), so a block's
// slice is always whole chunks and the scale of every chunk it carries
// travels with it.  Inside a block each warp takes one chunk at a time
// (quant.cuh).  Rank r's input is its (n, chunks, 256) f32 contributions,
// its output (chunks, 256) f32.  At hop h it sends the int8 encoding of its
// partial sum of chunk order[(pos - h) mod n]; on arrival it computes
// dequant(arrived) + own in f32 as one fused multiply-add (what XLA
// compiles the reference's dequantize-and-add to), in the reference's hop
// order (repro.core.odc.ring_scatter_accumulate_q8), and requantizes that
// for the next hop, so it is bitwise the plain ring.
//
// Bound on one H100 SXM (3.35 TB/s HBM3), with v values per shard (chunk)
// and n ranks on the card, each encoded value 1 + 4/256 bytes: the gather
// reads n encoded shards and writes n*n: (n + n^2) * v * 1.0156 B, the
// traffic the broadcast makes; the scatter reads n*n*v f32 contributions
// and writes n*v f32 sums: (n^2 + n) * v * 4 B, over 3.35e12 B/s.  What
// the scatter's simple design leaves on the table: every hop goes through
// a staging slot, and a waiting block spins instead of working.
#include "odc_bcast.cuh"
#include "odc_ring.cuh"
#include "quant.cuh"

// One hop's work on this block's chunks: acc = fma(code, scale, own) of
// the arrived chunk (or own alone at the first hop), then either its encoding into the right
// neighbour's slot (send) or acc itself into `out` (the last hop).
__device__ __forceinline__ void q8_scatter_hop(
    long long lo, long long hi, const float* own,
    const unsigned char* in_q, const float* in_s, unsigned char* send_q,
    float* send_s, float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  for (long long c = lo + warp; c < hi; c += ODC_THREADS / 32) {
    const long long at = c * Q8_CHUNK + lane * Q8_PER_LANE;
    float v[Q8_PER_LANE];
    q8_load(own + at, v);
    if (in_q)
      q8_decode_add(__ldcg(reinterpret_cast<const uint2*>(in_q + at)),
                    __ldcg(in_s + c), v);
    if (out) {
      q8_store(out + at, v);
      continue;
    }
    const float scale = q8_scale(q8_absmax(v));
    __stcg(reinterpret_cast<uint2*>(send_q + at), q8_encode(v, scale));
    if (lane == 0) __stcg(send_s + c, scale);
  }
}

__global__ void __launch_bounds__(ODC_THREADS)
odc_scatter_q8_kernel(const __grid_constant__ OdcArgs a) {
  const int n = a.n;
  const int r = blockIdx.y;
  const int p = a.pos[r];
  const int right = a.order[(p + 1) % n];
  const int B = gridDim.x, b = blockIdx.x;
  const unsigned long long epoch = *a.epoch;
  long long lo, hi;
  odc_slice(a, &lo, &hi);
  const long long nc = a.elems;

  const float* y = static_cast<const float*>(a.in[r]);
  float* out = static_cast<float*>(a.out[r]);
  unsigned char* mine = static_cast<unsigned char*>(a.stage[r]);
  unsigned char* theirs = static_cast<unsigned char*>(a.stage[right]);
  float* mine_s = reinterpret_cast<float*>(mine + 2 * a.slot_bytes);
  float* theirs_s = reinterpret_cast<float*>(theirs + 2 * a.slot_bytes);
  unsigned* my_flags = a.flags + (size_t)r * 2 * B;
  unsigned* their_flags = a.flags + (size_t)right * 2 * B;
  // my contributions to the chunk owned `off` ring positions behind me
  auto own = [&](int off) {
    return y + (long long)a.order[((p - off) % n + n) % n] * nc * Q8_CHUNK;
  };
  auto slot_q = [&](unsigned char* base, int slot) {
    return base + (long long)slot * a.slot_bytes;
  };

  if (n == 1) {
    q8_scatter_hop(lo, hi, own(0), nullptr, nullptr, nullptr, nullptr,
                   out);
    return;
  }
  // hop 1: my contribution to my left neighbour's chunk, encoded
  q8_scatter_hop(lo, hi, own(1), nullptr, nullptr, slot_q(theirs, 1),
                 theirs_s + nc, nullptr);
  odc_signal(their_flags + (size_t)1 * B + b, odc_tag(epoch, 1));
  for (int h = 2; h < n; ++h) {
    const int in_slot = (h - 1) & 1, out_slot = h & 1;
    odc_wait(my_flags + (size_t)in_slot * B + b, odc_tag(epoch, h - 1));
    // the right neighbour must have consumed hop h - 2 from this slot
    if (h >= 3) odc_wait(a.credits + (size_t)right * B + b,
                         odc_tag(epoch, h - 2));
    q8_scatter_hop(lo, hi, own(h), slot_q(mine, in_slot),
                   mine_s + (long long)in_slot * nc, slot_q(theirs, out_slot),
                   theirs_s + (long long)out_slot * nc, nullptr);
    odc_signal(their_flags + (size_t)out_slot * B + b, odc_tag(epoch, h));
    odc_signal(a.credits + (size_t)r * B + b, odc_tag(epoch, h - 1));
  }
  // the last hop brings my own chunk, summed over every other rank
  const int last = (n - 1) & 1;
  odc_wait(my_flags + (size_t)last * B + b, odc_tag(epoch, n - 1));
  q8_scatter_hop(lo, hi, own(n), slot_q(mine, last),
                 mine_s + (long long)last * nc, nullptr, nullptr, out);
}

__global__ void __launch_bounds__(ODC_BCAST_THREADS, ODC_BCAST_MIN_BLOCKS)
odc_gather_q8_kernel(const __grid_constant__ OdcBcastArgs a) {
  odc_bcast<2>(a);
}

extern "C" int repro_odc_gather_q8_capacity(int* blocks) {
  return odc_bcast_capacity((const void*)odc_gather_q8_kernel, blocks);
}

extern "C" int repro_odc_scatter_q8_capacity(int* blocks) {
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, odc_scatter_q8_kernel, ODC_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  *blocks = per_sm * sms;
  return 0;
}

// The gather: q_in, q_out, s_in, s_out are host arrays of n device
// pointers (rank r's codes and scales, and its (n, chunks, 256) codes and
// (n, chunks) scales).  Any grid of at least one block.  Returns a CUDA
// error code (0 on success; cudaErrorInvalidValue for arguments it does not
// take).
extern "C" int repro_odc_gather_q8(const void* const* q_in,
                                   void* const* q_out,
                                   const void* const* s_in,
                                   void* const* s_out, int n,
                                   long long chunks, int blocks_per_rank,
                                   void* stream) {
  OdcBcastArgs a = {};
  if (n < 1 || n > ODC_MAX_RANKS || blocks_per_rank < 1 || chunks < 1 ||
      !odc_bcast_payload(&a, 0, q_in, q_out, n, chunks * Q8_CHUNK,
                         Q8_CHUNK) ||
      !odc_bcast_payload(&a, 1, s_in, s_out, n, chunks * 4, 4))
    return (int)cudaErrorInvalidValue;
  a.units = chunks;
  odc_gather_q8_kernel<<<dim3(blocks_per_rank, n), ODC_BCAST_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The scatter: returns a CUDA error code (0 on success); a grid whose
// blocks cannot all be resident at once is refused without a launch.
// `dtype` is 0 (float32), the only type of the wire's decoded side.
extern "C" int repro_odc_scatter_q8(const void* const* in, void* const* out,
                                    void* const* stage, const int* order,
                                    int n, long long chunks, int dtype,
                                    int blocks_per_rank, unsigned* flags,
                                    unsigned* credits,
                                    const unsigned long long* epoch,
                                    void* stream) {
  if (n < 1 || n > ODC_MAX_RANKS || blocks_per_rank < 1 || chunks < 1 ||
      dtype != 0)
    return (int)cudaErrorInvalidValue;
  int cap;
  int e = repro_odc_scatter_q8_capacity(&cap);
  if (e != 0) return e;
  if ((long long)n * blocks_per_rank > cap)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  OdcArgs a = odc_args(in, out, stage, order, n, chunks, Q8_CHUNK,
                       blocks_per_rank, flags, credits, epoch);
  void* params[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)odc_scatter_q8_kernel, dim3(blocks_per_rank, n),
      dim3(ODC_THREADS), params, 0, static_cast<cudaStream_t>(stream));
  cudaError_t last = cudaGetLastError();  // clears a launch error
  return (int)(err != cudaSuccess ? err : last);
}
