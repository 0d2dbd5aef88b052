// Element types of the memory rings: float, or bf16 (deva_tpu's serving
// configuration, InferenceConfig.ring_dtype). A kernel that reads a ring is
// a template on its element type T and works in f32: widen() turns an
// element into the float it stands for, exactly (a bf16 is the upper 16
// bits of that float), and weight<T>() rounds a readout weight to T, as the
// Pallas kernels cast the affinity to the value ring's dtype before the
// MXU product. The product of two bf16 numbers is exact in f32, so a bf16
// readout differs from the f32 one on the same widened rows only by that
// rounding of the weights.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace deva_ring {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ float weight(float w);
template <>
__device__ __forceinline__ float weight<float>(float w) {
  return w;
}
template <>
__device__ __forceinline__ float weight<bf16>(float w) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

// Elements of T in one 16-byte vector.
template <typename T>
constexpr int kVec16 = 16 / (int)sizeof(T);

// One element at p (global memory) through the read-only path, widened.
__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg1(const bf16* p) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// 16 bytes as kVec16<T> floats, in order.
__device__ __forceinline__ void unpack16(uint4 v, const float*, float* out) {
  out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack16(uint4 v, const bf16*, float* out) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little-endian: element 2i is the low half
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The 16 bytes at p (16-byte aligned, in shared or global memory) widened.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  unpack16(*reinterpret_cast<const uint4*>(p), p, out);
}

// The same through the read-only path (p in global memory).
template <typename T>
__device__ __forceinline__ void ldg16(const T* p, float* out) {
  unpack16(__ldg(reinterpret_cast<const uint4*>(p)), p, out);
}

}  // namespace deva_ring
