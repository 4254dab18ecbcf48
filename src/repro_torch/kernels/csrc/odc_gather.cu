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

// ---------------------------------------------------------------------------
// Chained gather: L rings in one launch.
//
// Replaces the TPU kernel repro.kernels.odc_gather.odc_gather_layers_pallas
// (src/repro/kernels/odc_gather.py:188, _gather_layers_kernel at :131):
// rank r's stacked (L, c) shard -> its (L, n, c) output, the rings of
// consecutive layers chained through the same two staging slots with one
// global hop counter g = l * (n - 1) + i (tags: odc_ring.cuh), so layer
// l + 1's first hop follows layer l's last without a barrier.
//
// The TPU kernel stages each layer's own shard in a separate two-slot
// inject buffer, because its hop 0 sends from VMEM and re-staging into a
// ring slot at a layer boundary would race the left neighbour's write into
// that slot.  Here hop 0 of every layer pushes straight from the input
// x[l] in device memory (as the single-layer kernel does), so no rank ever
// writes its own ring slots: only its left neighbour does, under the
// credits.  The slot of a layer's last hop is copied out and never
// forwarded; its credit is released at the next hop like every other.
//
// Per-layer readiness: after a block has filed every rank's rows of layer
// l for its slice, it adds one to done[l] (after a fence).  done[l] grows
// by n * blocks per launch and is never reset; the wrapper keeps the
// running total on the host, and the compute stream waits with
// cuStreamWaitValue32 for done[l] to reach it before it reads layer l.
//
// Bound on one H100 SXM: as the single-layer gather, per layer, so
// (n + n^2) * c * L bytes at 3.35 TB/s.  The copies issue four 16-byte
// loads per thread before storing, since a small grid (CHAIN_SHARE) has
// few threads to keep memory busy.

// Copy nbytes with every load through L2 (the sources are staging slots
// written by other blocks, or inputs written by another stream).
__device__ __forceinline__ void odc_copy_cg(unsigned char* dst,
                                            const unsigned char* src,
                                            long long nbytes) {
  long long done = 0;
  if (odc_aligned16(dst, src, dst)) {
    const long long nv = nbytes >> 4;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const long long T = blockDim.x;
    for (long long i0 = threadIdx.x; i0 < nv; i0 += 4 * T) {
      uint4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i0 + j * T < nv) v[j] = __ldcg(s + i0 + j * T);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i0 + j * T < nv) __stcg(d + i0 + j * T, v[j]);
    }
    done = nv << 4;
  }
  for (long long i = done + threadIdx.x; i < nbytes; i += blockDim.x)
    dst[i] = __ldcg(src + i);
}

__global__ void __launch_bounds__(ODC_THREADS)
odc_gather_layers_kernel(const __grid_constant__ OdcArgs a, int elem_bytes,
                         int layers, unsigned* done,
                         unsigned long long base) {
  const int n = a.n;
  const int r = blockIdx.y;
  const int p = a.pos[r];
  const int right = a.order[(p + 1) % n];
  const int B = gridDim.x, b = blockIdx.x;
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

  for (int l = 0; l < layers; ++l) {
    const unsigned char* xl = x + (long long)l * cb;
    unsigned char* ol = out + (long long)l * n * cb;
    odc_copy_cg(ol + (long long)r * cb + off, xl + off, nb);
    for (int i = 0; i < n - 1; ++i) {
      const long long h = (long long)l * (n - 1) + i;
      const int slot = (int)(h & 1);
      // the right neighbour must have released this slot (hop h - 2)
      if (h >= 2) odc_wait(a.credits + (size_t)right * B + b,
                           odc_chain_tag(base, h - 2));
      // push: layer l's own shard at its hop 0, else what arrived last hop
      const unsigned char* src =
          i == 0 ? xl : mine + (long long)((h - 1) & 1) * a.slot_bytes;
      odc_copy_cg(theirs + (long long)slot * a.slot_bytes + off, src + off,
                  nb);
      odc_signal(their_flags + (size_t)slot * B + b, odc_chain_tag(base, h));
      // hop h - 1's slot is forwarded (or, at a layer's first hop, was
      // filed at the end of the previous layer): release it
      if (h >= 1) odc_signal(a.credits + (size_t)r * B + b,
                             odc_chain_tag(base, h - 1));
      odc_wait(my_flags + (size_t)slot * B + b, odc_chain_tag(base, h));
      const int src_rank = a.order[((p - i - 1) % n + n) % n];
      odc_copy_cg(ol + (long long)src_rank * cb + off,
                  mine + (long long)slot * a.slot_bytes + off, nb);
    }
    if (done != nullptr) {  // this block's slice of layer l is filed
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(done + l, 1u);
      }
    }
  }
}

extern "C" int repro_odc_gather_layers_capacity(int* blocks) {
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, odc_gather_layers_kernel, ODC_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  *blocks = per_sm * sms;
  return 0;
}

// Returns a CUDA error code (0 on success); refuses, without launching, a
// grid whose blocks cannot all be resident at once.  `elems` is c, the
// elements of one layer's shard; `done` (L words) may be null; `base` is
// the launch's tag base (odc_ring.cuh).
extern "C" int repro_odc_gather_layers(const void* const* in,
                                       void* const* out, void* const* stage,
                                       const int* order, int n,
                                       long long elems, int elem_bytes,
                                       int blocks_per_rank, unsigned* flags,
                                       unsigned* credits,
                                       unsigned long long base, int layers,
                                       unsigned* done, void* stream) {
  if (n < 1 || n > ODC_MAX_RANKS || blocks_per_rank < 1 || elem_bytes < 1 ||
      layers < 1)
    return (int)cudaErrorInvalidValue;
  int cap;
  int e = repro_odc_gather_layers_capacity(&cap);
  if (e != 0) return e;
  if ((long long)n * blocks_per_rank > cap)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  OdcArgs a = odc_args(in, out, stage, order, n, elems, elem_bytes,
                       blocks_per_rank, flags, credits, nullptr);
  void* params[] = {&a, &elem_bytes, &layers, &done, &base};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)odc_gather_layers_kernel, dim3(blocks_per_rank, n),
      dim3(ODC_THREADS), params, 0, static_cast<cudaStream_t>(stream));
  cudaError_t last = cudaGetLastError();  // clears a launch error
  return (int)(err != cudaSuccess ? err : last);
}
