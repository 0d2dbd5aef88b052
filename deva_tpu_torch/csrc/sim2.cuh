// The one similarity of the threshold-approx pair (segmax.cu and
// denom_readout.cu), in the one-product form of the Pallas `_sim_tile2`
// (deva_tpu/ops/pallas_attention.py:380-427):
//
//   sim[q, n] = (qcat[q] . mcat[n] - sub) * msv[n],   -inf if n is invalid
//
// with qcat = [2*qk*qe ; -qe], mcat = [mk ; mk^2] and sub = bsq[q] =
// sum(qe*qk^2) when a selection is present, else qcat = 2*qk, mcat = mk and
// sub = msq[n] = sum(mk^2); msv = ms / sqrt(Ck).
//
// Both kernels must see the same float for the same (q, n): `segmax` folds
// it into the group maxima that set the threshold th, and `denom_readout`
// tests it against th. If the two roundings differed, the token that set a
// group max could fall one ulp below th, and the support would no longer
// contain the exact top-k. So every similarity of the pair is built the same
// way: a chain of fmaf over c = 0, 1, ..., kc-1 starting from 0.f (acc_step,
// in the register tiles of segmax and in dot_row), then finish(). The build
// uses no fast-math flag, so the compiler keeps that order; true f32, no
// TF32 (the Pallas code runs at HIGHEST precision).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace deva_sim2 {

__device__ __forceinline__ float acc_step(float acc, float qv, float mv) {
  return fmaf(qv, mv, acc);
}

__device__ __forceinline__ float finish(float acc, float sub, float msv,
                                        bool valid) {
  return valid ? (acc - sub) * msv : -INFINITY;
}

// The fmaf chain of one (q, n) pair; kc % 4 == 0 and both rows 16-byte
// aligned. The float4 loads do not change the order of the sum.
__device__ __forceinline__ float dot_row(const float* q, const float* m,
                                         int kc) {
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4* m4 = reinterpret_cast<const float4*>(m);
  float acc = 0.f;
  for (int c = 0; c < kc / 4; ++c) {
    const float4 a = q4[c];
    const float4 b = __ldg(&m4[c]);
    acc = acc_step(acc, a.x, b.x);
    acc = acc_step(acc, a.y, b.y);
    acc = acc_step(acc, a.z, b.z);
    acc = acc_step(acc, a.w, b.w);
  }
  return acc;
}

}  // namespace deva_sim2
