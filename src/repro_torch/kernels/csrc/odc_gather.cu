// ODC gather: the ring all-gather of parameter shards as one-sided pushes,
// every rank of the ring on this card, in one cooperative launch.
//
// Replaces the TPU kernel repro.kernels.odc_gather.odc_gather_pallas
// (src/repro/kernels/odc_gather.py:95, _gather_kernel at :47), whose hops
// are remote DMAs into the right neighbour's VMEM staging slot signalled by
// DMA semaphores, with credit-based backpressure.  Here a hop is a copy by
// the sending block into the neighbour's staging slot in device memory,
// signalled by a flag (see odc_ring.cuh for the protocol).
//
// Grid (blocks_per_rank, n): block (b, r) is rank r's worker for slice b of
// the shard and carries that slice through every hop; flags are per (rank,
// slot, block), so slices move independently.  Rank r's output is (n, c):
// row r is its own shard, row order[(pos - i - 1) mod n] arrives at hop i.
// The kernel moves bytes, so it serves every element type.
//
// Bound on one H100 SXM (3.35 TB/s HBM3): with c bytes per shard and n
// ranks on the card, the least traffic is n*c read (each shard once) plus
// n*n*c written (every rank's full output): (n + n^2) * c / 3.35e12 s.
// What this simple design leaves on the table: every hop goes through a
// staging slot and out again, so each forwarded shard is written and read
// twice more than needed (about 3x the bound's traffic at large n), and a
// block that waits for its left neighbour spins instead of doing other
// work.  A later version can push straight into the neighbour's output,
// use the copy engines or TMA, and run across cards with peer pointers.
#include "odc_ring.cuh"

// Copy nbytes; `staged` marks a source in a staging slot written by
// another block, read through L2 only.
__device__ __forceinline__ void odc_copy(unsigned char* dst,
                                         const unsigned char* src,
                                         long long nbytes, bool staged) {
  long long done = 0;
  if (odc_aligned16(dst, src, dst)) {
    const long long nv = nbytes >> 4;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long i = threadIdx.x; i < nv; i += blockDim.x)
      __stcg(d + i, staged ? __ldcg(s + i) : s[i]);
    done = nv << 4;
  }
  for (long long i = done + threadIdx.x; i < nbytes; i += blockDim.x)
    dst[i] = staged ? __ldcg(src + i) : src[i];
}

__global__ void __launch_bounds__(ODC_THREADS)
odc_gather_kernel(const __grid_constant__ OdcArgs a, int elem_bytes) {
  const int n = a.n;
  const int r = blockIdx.y;
  const int p = a.pos[r];
  const int right = a.order[(p + 1) % n];
  const int B = gridDim.x, b = blockIdx.x;
  const unsigned long long epoch = *a.epoch;
  long long lo, hi;
  odc_slice(a, &lo, &hi);
  const long long off = lo * elem_bytes, nb = (hi - lo) * elem_bytes;
  const long long cb = a.elems * elem_bytes;

  const unsigned char* x = static_cast<const unsigned char*>(a.in[r]);
  unsigned char* out = static_cast<unsigned char*>(a.out[r]);
  unsigned char* mine = static_cast<unsigned char*>(a.stage[r]);
  unsigned char* theirs = static_cast<unsigned char*>(a.stage[right]);
  unsigned* my_flags = a.flags + (size_t)r * 2 * B;
  unsigned* their_flags = a.flags + (size_t)right * 2 * B;

  odc_copy(out + (long long)r * cb + off, x + off, nb, false);
  for (int i = 0; i < n - 1; ++i) {
    const int slot = i & 1;
    // the right neighbour must have released this slot (hop i - 2)
    if (i >= 2) odc_wait(a.credits + (size_t)right * B + b,
                         odc_tag(epoch, i - 2));
    // push: my shard at hop 0, then what arrived at the previous hop
    const unsigned char* src =
        i == 0 ? x : mine + (long long)((i - 1) & 1) * a.slot_bytes;
    odc_copy(theirs + (long long)slot * a.slot_bytes + off, src + off, nb,
             i > 0);
    odc_signal(their_flags + (size_t)slot * B + b, odc_tag(epoch, i));
    // hop i - 1's slot is copied out and forwarded: release it
    if (i >= 1) odc_signal(a.credits + (size_t)r * B + b,
                           odc_tag(epoch, i - 1));
    // receive hop i and file it at its owner's rows
    odc_wait(my_flags + (size_t)slot * B + b, odc_tag(epoch, i));
    const int src_rank = a.order[((p - i - 1) % n + n) % n];
    odc_copy(out + (long long)src_rank * cb + off,
             mine + (long long)slot * a.slot_bytes + off, nb, true);
  }
}

extern "C" int repro_odc_gather_capacity(int* blocks) {
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, odc_gather_kernel, ODC_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  *blocks = per_sm * sms;
  return 0;
}

// Returns a CUDA error code (0 on success); refuses, without launching, a
// grid whose blocks cannot all be resident at once (they wait on each
// other, so a partial grid would hang).
extern "C" int repro_odc_gather(const void* const* in, void* const* out,
                                void* const* stage, const int* order, int n,
                                long long elems, int elem_bytes,
                                int blocks_per_rank, unsigned* flags,
                                unsigned* credits,
                                const unsigned long long* epoch,
                                void* stream) {
  if (n < 1 || n > ODC_MAX_RANKS || blocks_per_rank < 1 || elem_bytes < 1)
    return (int)cudaErrorInvalidValue;
  int cap;
  int e = repro_odc_gather_capacity(&cap);
  if (e != 0) return e;
  if ((long long)n * blocks_per_rank > cap)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  OdcArgs a = odc_args(in, out, stage, order, n, elems, elem_bytes,
                       blocks_per_rank, flags, credits, epoch);
  void* params[] = {&a, &elem_bytes};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)odc_gather_kernel, dim3(blocks_per_rank, n),
      dim3(ODC_THREADS), params, 0, static_cast<cudaStream_t>(stream));
  cudaError_t last = cudaGetLastError();  // clears a launch error
  return (int)(err != cudaSuccess ? err : last);
}
