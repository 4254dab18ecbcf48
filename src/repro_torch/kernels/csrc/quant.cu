// The chunked int8 codec: (n_chunks, 256) f32 <-> (n_chunks, 256) int8 and
// (n_chunks) f32 scales, the wire format of the pipe-int8 backend.
//
// Replaces the TPU kernels repro.kernels.quant.quantize_pallas
// (src/repro/kernels/quant.py:52, _quantize_kernel at :43) and
// dequantize_pallas (:68, _dequantize_kernel at :64), which run the whole
// (n_chunks, 256) block in VMEM at once.  Here one warp owns one chunk:
// each lane loads 8 values, the absmax is a warp shuffle reduction, and
// the codes and the scale are written straight back (quant.cuh holds the
// arithmetic, bitwise the reference's).  A block of 8 warps takes 8
// consecutive chunks; nothing carries between blocks.
//
// Bound on one H100 SXM (3.35 TB/s HBM3): the codec moves bytes and does
// a few operations per value.  Quantize reads 4 B and writes 1 + 4/256 B
// per value, dequantize the reverse: 5.0156 B per value either way, so
// n_chunks * 256 * 5.0156 / 3.35e12 s.  This simple design reads each
// value once into registers and writes each code once, so it can come
// near that bound; what it leaves on the table is the 8-byte stores of
// the codes (16-byte stores of two lanes' codes would halve the store
// instructions).
#include "quant.cuh"

__global__ void __launch_bounds__(Q8_THREADS)
q8_quantize_kernel(const float* __restrict__ x, uint8_t* __restrict__ q,
                   float* __restrict__ scales, long long chunks) {
  const long long c = (long long)blockIdx.x * (Q8_THREADS / 32) +
                      threadIdx.x / 32;
  if (c >= chunks) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const long long at = c * Q8_CHUNK + lane * Q8_PER_LANE;
  float v[Q8_PER_LANE];
  q8_load(x + at, v);
  const float scale = q8_scale(q8_absmax(v));
  *reinterpret_cast<uint2*>(q + at) = q8_encode(v, scale);
  if (lane == 0) scales[c] = scale;
}

__global__ void __launch_bounds__(Q8_THREADS)
q8_dequantize_kernel(const uint8_t* __restrict__ q,
                     const float* __restrict__ scales,
                     float* __restrict__ out, long long chunks) {
  const long long c = (long long)blockIdx.x * (Q8_THREADS / 32) +
                      threadIdx.x / 32;
  if (c >= chunks) return;
  const int lane = threadIdx.x & 31;
  const long long at = c * Q8_CHUNK + lane * Q8_PER_LANE;
  float v[Q8_PER_LANE];
  q8_decode(*reinterpret_cast<const uint2*>(q + at), scales[c], v);
  q8_store(out + at, v);
}

static dim3 q8_grid(long long chunks) {
  return dim3((unsigned)((chunks + Q8_THREADS / 32 - 1) / (Q8_THREADS / 32)));
}

// Each returns a CUDA error code (0 on success).  Pointers are 16-byte
// aligned, as the wrapper checks.
extern "C" int repro_quantize(const void* x, void* q, void* scales,
                              long long chunks, void* stream) {
  if (chunks < 1) return (int)cudaErrorInvalidValue;
  q8_quantize_kernel<<<q8_grid(chunks), Q8_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint8_t*>(q),
      static_cast<float*>(scales), chunks);
  return (int)cudaGetLastError();
}

extern "C" int repro_dequantize(const void* q, const void* scales, void* out,
                                long long chunks, void* stream) {
  if (chunks < 1) return (int)cudaErrorInvalidValue;
  q8_dequantize_kernel<<<q8_grid(chunks), Q8_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), chunks);
  return (int)cudaGetLastError();
}
