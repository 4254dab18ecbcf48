// The chunked int8 wire format on the card, shared by the codec kernels
// (quant.cu) and the compressed rings (odc_q8.cu).
//
// A chunk is Q8_CHUNK = 256 consecutive f32 values, held by one warp: lane
// l holds values [8l, 8l + 8).  Its scale is absmax * fl(1/127), or 1.0
// for an all-zero chunk; a value's code is rint(x / scale) clamped to
// +-127.  The reference (repro.core.odc.quantize_chunked) writes the scale
// as absmax / 127.0, which XLA compiles to the product with the f32
// reciprocal of the constant on every jitted path (the engine, the rings
// under shard_map, the Pallas kernels), and divides x by the scale in IEEE
// f32 and rounds half to even (jnp.round).  So the scale is one IEEE
// product (__fmul_rn), the division __fdiv_rn (never a reciprocal or
// --use_fast_math) and the rounding rintf (never roundf, which rounds ties
// away from zero).  Decoding is (float)q * scale, one IEEE product
// (__fmul_rn keeps nvcc from contracting it into an add).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define Q8_CHUNK 256
#define Q8_PER_LANE 8  // Q8_CHUNK / 32
#define Q8_THREADS 256 // 8 warps, one chunk each at a time
#define Q8_INV_127 0x1.020408p-7f  // 1/127 rounded to f32

// The chunk's absmax over the warp, on every lane.
__device__ __forceinline__ float q8_absmax(const float v[Q8_PER_LANE]) {
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < Q8_PER_LANE; ++i) m = fmaxf(m, fabsf(v[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

__device__ __forceinline__ float q8_scale(float absmax) {
  return absmax > 0.0f ? __fmul_rn(absmax, Q8_INV_127) : 1.0f;
}

// Encode this lane's 8 values with the chunk's scale, as 8 packed int8.
__device__ __forceinline__ uint2 q8_encode(const float v[Q8_PER_LANE],
                                           float scale) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < Q8_PER_LANE; ++i) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(v[i], scale)), -127.0f),
                          127.0f);
    const uint32_t b = (uint32_t)(uint8_t)(int8_t)r;
    w[i >> 2] |= b << (8 * (i & 3));
  }
  return make_uint2(w[0], w[1]);
}

// Decode 8 packed int8 with their chunk's scale.
__device__ __forceinline__ void q8_decode(uint2 q, float scale,
                                          float v[Q8_PER_LANE]) {
  const uint32_t w[2] = {q.x, q.y};
#pragma unroll
  for (int i = 0; i < Q8_PER_LANE; ++i) {
    const int8_t b = (int8_t)((w[i >> 2] >> (8 * (i & 3))) & 0xffu);
    v[i] = __fmul_rn((float)b, scale);
  }
}

// v[i] = code * scale + v[i] with one rounding (__fmaf_rn): the reference's
// dequantize-and-add as XLA compiles it, one fused multiply-add.
__device__ __forceinline__ void q8_decode_add(uint2 q, float scale,
                                              float v[Q8_PER_LANE]) {
  const uint32_t w[2] = {q.x, q.y};
#pragma unroll
  for (int i = 0; i < Q8_PER_LANE; ++i) {
    const int8_t b = (int8_t)((w[i >> 2] >> (8 * (i & 3))) & 0xffu);
    v[i] = __fmaf_rn((float)b, scale, v[i]);
  }
}

__device__ __forceinline__ void q8_load(const float* p,
                                        float v[Q8_PER_LANE]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void q8_store(float* p,
                                         const float v[Q8_PER_LANE]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
