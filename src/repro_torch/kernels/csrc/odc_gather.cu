// ODC gather: the all-gather of parameter shards, every rank of the ring on
// this card.
//
// Single leaf (repro_odc_gather): replaces the TPU kernel
// repro.kernels.odc_gather.odc_gather_pallas (src/repro/kernels/
// odc_gather.py:95, _gather_kernel at :47), whose hops are remote DMAs into
// the right neighbour's VMEM staging slot signalled by DMA semaphores, with
// credit-based backpressure.  Rank r's (c) shard -> its (n, c) output, row
// s holding rank s's shard whatever the ring order.
//
// Why no ring here: every rank lies on one card, so every shard is already
// addressable through the pointer table.  A ring's hops copied each
// forwarded shard into a staging slot in device memory and out again
// (about 3x the bound's traffic at large n) and made every block wait on
// flags for its neighbour, so that every block had to be resident at once.
// Instead block (b, s) of odc_gather_kernel reads slice b of shard s once
// and stores it to row s of every output: the read-once broadcast of
// odc_bcast.cuh, one payload of `nbytes` bytes a shard cut into 16-byte
// units.  The kernel moves bytes, so it serves every element type and
// keeps NaN bit patterns.
//
// Bound on one H100 SXM (3.35 TB/s HBM3): with c bytes per shard and n
// ranks on the card, each shard read once (n*c) and every rank's full
// output written once (n*n*c): (n + n^2) * c / 3.35e12 s, which is the
// traffic this kernel makes.
//
// Across cards (ROADMAP queue 1 item 9): the table holds peer pointers to
// the shards (a peer-mapped or IPC allocation) and the reads go over
// NVLink; nothing else changes.
#include "odc_bcast.cuh"

__global__ void __launch_bounds__(ODC_BCAST_THREADS, ODC_BCAST_MIN_BLOCKS)
odc_gather_kernel(const __grid_constant__ OdcBcastArgs a) {
  odc_bcast<1>(a);
}

extern "C" int repro_odc_gather_capacity(int* blocks) {
  return odc_bcast_capacity((const void*)odc_gather_kernel, blocks);
}

// in, out: host arrays of n device pointers (rank r's shard of `nbytes`
// bytes and its (n, nbytes) output).  Any grid of at least one block.
// Returns a CUDA error code (0 on success; cudaErrorInvalidValue for
// arguments it does not take, outputs not congruent mod 16 among them).
extern "C" int repro_odc_gather(const void* const* in, void* const* out,
                                int n, long long nbytes, int blocks_per_rank,
                                void* stream) {
  OdcBcastArgs a = {};
  if (n < 1 || n > ODC_MAX_RANKS || blocks_per_rank < 1 || nbytes < 0 ||
      !odc_bcast_payload(&a, 0, in, out, n, nbytes, 16))
    return (int)cudaErrorInvalidValue;
  a.units = (nbytes + 15) / 16;
  odc_gather_kernel<<<dim3(blocks_per_rank, n), ODC_BCAST_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
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
