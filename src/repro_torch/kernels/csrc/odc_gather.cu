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
// Chained gather: L rings in one launch, as a cluster kernel whose hops go
// through distributed shared memory.
//
// Replaces the TPU kernel repro.kernels.odc_gather.odc_gather_layers_pallas
// (src/repro/kernels/odc_gather.py:188, _gather_layers_kernel at :131):
// rank r's stacked (L, c) shard -> its (L, n, c) output, the rings of
// consecutive layers chained so that layer l + 1's first hop follows layer
// l's last without a barrier.  The TPU kernel's hop is a remote DMA into
// the right neighbour's VMEM staging slot, signalled by a DMA semaphore;
// here it is a bulk copy into the right neighbour's shared-memory slot,
// signalled by that slot's mbarrier (protocol: odc_cluster.cuh).
//
// Per layer and tile, rank r's block loads its own tile once (TMA bulk
// load into an own slot), stores it to its output row r and pushes it into
// the right neighbour's recv slot of hop 1.  At hop h (1..n-1) the tile of
// rank order[(pos - h) mod n] arrives in that hop's recv slot; the block
// stores it to that rank's row and, before the last hop, forwards it into
// the right neighbour's slot of hop h + 1.  Every store is a bulk store
// from shared memory.  Slot release: an own slot is free once its store
// has read it and the right neighbour has seen its push land (count 2); a
// recv slot likewise, and the block that frees it arrives on its writer's
// rfree barrier (the ack of a forward comes from two positions to the
// right of the writer).
//
// Threads: one warp for each stream, its lane 0 alone issuing: warp 0 the
// loads, warp 1 the stores and pushes of the own tiles, warp 1 + h the
// receipt, store and forward of hop h (1..n-1), so that no stream waits
// for another (odc_cluster.cuh), not even inside a warp.  Rows
// that are not 16-byte aligned in device memory (c * elem_bytes % 16 != 0,
// or a base pointer) are copied between device and shared memory by the
// issuing thread instead; the hops stay bulk copies.
//
// Per-layer readiness: after a thread's last store of layer l it drains
// its bulk stores (cp.async.bulk.wait_group 0), fences, and adds one to
// done[l] (odc_layer_done): each of a block's n storing threads does, so
// done[l] grows by n * n * blocks per launch.  It is never reset; the
// wrapper keeps the running total on the host, and the compute stream
// waits with cuStreamWaitValue32 for done[l] to reach it before it reads
// layer l.
//
// Bound on one H100 SXM (3.35 TB/s HBM3): device memory sees each shard
// read once (n * c) and every output written once (n^2 * c), per layer:
// (n + n^2) * c * L bytes.  Nothing else touches device memory: the hops
// go SM to SM.
#include "odc_cluster.cuh"

// warps: the loads, the own tiles, one for each hop
#define ODC_GATHER_CHAIN_THREADS(n) (32 * ((n) + 1))

__global__ void __launch_bounds__(ODC_GATHER_CHAIN_THREADS(ODC_MAX_RANKS))
odc_gather_layers_kernel(const __grid_constant__ ChainArgs a,
                         unsigned* done) {
  extern __shared__ __align__(128) unsigned char odc_smem[];
  const ChainSmem s = odc_chain_smem(odc_smem, a);
  const int n = a.n;
  const int r = blockIdx.y;  // the cluster rank: cluster dims (1, n, 1)
  const int p = a.pos[r];
  const int right = a.order[(p + 1) % n];
  const int left = a.order[(p + n - 1) % n];
  const int left2 = a.order[(p + 2 * n - 2) % n];
  const ChainSlice g = odc_chain_slice(a);
  const int es = a.elem_bytes, tb = a.tile_bytes, S = a.own_slots;
  const long long cb = a.elems * es;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  odc_chain_init(s, a, n > 1 ? 2 : 1, 0, 2);

  const unsigned char* x = static_cast<const unsigned char*>(a.in[r]);
  unsigned char* out = static_cast<unsigned char*>(a.out[r]);
  OdcPending pend{0, 0};
  // a tile from shared memory to its row; `bar`, `count`: the arrivals
  // that free its slot once the store has read it
  auto store = [&](unsigned char* dst, const unsigned char* slot,
                   long long ne, uint32_t bar, uint32_t count) {
    if (a.aligned) {
      odc_bulk_store(dst, slot, (uint32_t)(ne * es));
      odc_pending_add(pend, bar, count);
    } else {
      odc_copy_elems(dst, slot, ne, es);
      odc_arrive_cluster(bar, count);
    }
  };
  // into the right neighbour's recv slot of hop h of tile k (this thread
  // is the only one that writes that slot)
  auto push = [&](const unsigned char* src, long long k, int h,
                  uint32_t bytes) {
    const int q = odc_recv_slot(a, k, h);
    const long long v = k / a.recv_depth;
    if (v > 0) odc_bar_wait(s.rfree + q, (uint32_t)((v - 1) & 1), &pend);
    odc_bulk_push(odc_mapa(odc_smem_u32(s.recv + (long long)q * tb), right),
                  src, bytes, odc_mapa(odc_smem_u32(s.full_recv + q), right));
  };

  if (lane != 0) {
    // idle: lane 0 of each warp issues its stream alone
  } else if (warp == 0) {
    // the loads: rank r's own tile of every (layer, tile), in order
    for (int l = 0; l < a.layers; ++l)
      for (int t = 0; t < g.tiles; ++t) {
        const long long k = (long long)l * g.tiles + t;
        const int o = (int)(k % S);
        const long long u = k / S;
        const long long e0 = g.lo + t * g.te;
        const long long ne = min(g.te, g.hi - e0);
        if (u > 0) odc_bar_wait(s.empty_own + o, (uint32_t)((u - 1) & 1));
        unsigned char* slot = s.own + (long long)o * tb;
        const unsigned char* src = x + l * cb + e0 * es;
        if (a.aligned) {
          odc_arrive_expect(s.full_own + o, (uint32_t)(ne * es));
          odc_bulk_load(slot, src, (uint32_t)(ne * es), s.full_own + o);
        } else {
          odc_copy_elems(slot, src, ne, es);
          odc_fence_async_smem();
          odc_arrive_local(s.full_own + o);
        }
      }
  } else if (warp == 1) {
    // hop 0: every own tile to row r and into the right neighbour
    for (int l = 0; l < a.layers; ++l) {
      unsigned char* ol = out + ((long long)l * n + r) * cb;
      for (int t = 0; t < g.tiles; ++t) {
        const long long k = (long long)l * g.tiles + t;
        const int o = (int)(k % S);
        const long long e0 = g.lo + t * g.te;
        const long long ne = min(g.te, g.hi - e0);
        unsigned char* slot = s.own + (long long)o * tb;
        odc_bar_wait(s.full_own + o, (uint32_t)((k / S) & 1), &pend);
        store(ol + e0 * es, slot, ne,
              odc_mapa(odc_smem_u32(s.empty_own + o), r), 1);
        if (n > 1) push(slot, k, 1, odc_push_bytes(ne * es));
      }
      if (done != nullptr) odc_layer_done(done, l, pend);
    }
    odc_pending_flush(pend);
    odc_bulk_wait_all();
  } else {
    // hop h: the tile of rank order[(pos - h) mod n], stored and forwarded
    const int h = warp - 1;
    const int src_rank = a.order[(p - h + n) % n];
    for (int l = 0; l < a.layers; ++l) {
      unsigned char* ol = out + ((long long)l * n + src_rank) * cb;
      for (int t = 0; t < g.tiles; ++t) {
        const long long k = (long long)l * g.tiles + t;
        const long long e0 = g.lo + t * g.te;
        const long long ne = min(g.te, g.hi - e0);
        const uint32_t pb = odc_push_bytes(ne * es);
        const int q = odc_recv_slot(a, k, h);
        unsigned char* rs = s.recv + (long long)q * tb;
        odc_arrive_expect(s.full_recv + q, pb);
        odc_bar_wait(s.full_recv + q, (uint32_t)((k / a.recv_depth) & 1),
                     &pend);
        // the push landed: its source slot may be written again
        if (h == 1)
          odc_arrive_cluster(
              odc_mapa(odc_smem_u32(s.empty_own + (int)(k % S)), left), 1);
        else
          odc_arrive_cluster(
              odc_mapa(odc_smem_u32(s.rfree + odc_recv_slot(a, k, h - 1)),
                       left2), 1);
        // the last hop's slot is not forwarded: both arrivals here
        store(ol + e0 * es, rs, ne, odc_mapa(odc_smem_u32(s.rfree + q), left),
              h == n - 1 ? 2 : 1);
        if (h < n - 1) push(rs, k, h + 1, pb);
      }
      if (done != nullptr) odc_layer_done(done, l, pend);
    }
    odc_pending_flush(pend);
    odc_bulk_wait_all();
  }
  __syncthreads();
  odc_cluster_sync();
}

extern "C" int repro_odc_gather_layers_capacity(int n, int smem,
                                                int* clusters) {
  return odc_chain_capacity((const void*)odc_gather_layers_kernel, n,
                            ODC_GATHER_CHAIN_THREADS(n), smem, clusters);
}

// Returns a CUDA error code (0 on success); refuses, without launching, a
// grid of more clusters than the card can hold at once
// (cudaErrorCooperativeLaunchTooLarge).  `elems` is c, the elements of one
// layer's shard; `slice`, `tile_bytes`, the slot counts (first_slots is
// the scatter's, 0 here) and `blocks_per_rank` are the wrapper's launch
// plan (_ring.chain_plan); `done` (L words) may be null.
extern "C" int repro_odc_gather_layers(const void* const* in,
                                       void* const* out, const int* order,
                                       int n, long long elems, int elem_bytes,
                                       int layers, long long slice,
                                       int tile_bytes, int own_slots,
                                       int first_slots, int recv_depth,
                                       int blocks_per_rank, unsigned* done,
                                       void* stream) {
  ChainArgs a;
  if (blocks_per_rank < 1 || first_slots != 0 ||
      !odc_chain_args(&a, in, out, order, n, layers, elems, elem_bytes,
                      slice, tile_bytes, own_slots, first_slots, recv_depth))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)odc_chain_smem_bytes(n, tile_bytes, own_slots,
                                             first_slots, recv_depth);
  int clusters;
  int e = repro_odc_gather_layers_capacity(n, smem, &clusters);
  if (e != 0) return e;
  if (blocks_per_rank > clusters)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  odc_chain_config(&cfg, &attr, blocks_per_rank, n,
                   ODC_GATHER_CHAIN_THREADS(n), smem,
                   static_cast<cudaStream_t>(stream));
  void* params[] = {&a, &done};
  cudaError_t err = cudaLaunchKernelExC(
      &cfg, (const void*)odc_gather_layers_kernel, params);
  cudaError_t last = cudaGetLastError();  // clears a launch error
  return (int)(err != cudaSuccess ? err : last);
}
