// Sparse top-k readout: out[q, :] = sum_r w[q, r] * V[idx[q, r], :].
//
// Replaces the Pallas kernel `_readout_kernel`
// (deva_tpu/ops/pallas_attention.py:249-305, reached by `topk_readout`).
// The Pallas kernel rebuilds a dense [Q_T, N_T] affinity tile from the
// (idx, w) pairs and multiplies it against the value ring on the MXU: 2*Q*N*C
// multiply-adds, most of them by zero. Here each query gathers its k value
// rows directly: Q*k*C multiply-adds.
//
// What bounds it on the H100: bytes. At the 480p serving shape (Q=1620,
// k=30, C=2*512) the kernel reads Q*k*C*4 = 199 MB of value rows (the ring
// itself is 68 MB, more than the 50 MB L2, so some rows come from device
// memory more than once) for 50 M multiply-adds.
//
// Design: one block per (query, 1024-column chunk); the query's k indices
// and weights are staged in shared memory, and each thread accumulates four
// neighbouring columns in f32 from 16-byte loads, so a warp reads 512
// contiguous bytes of a value row at a time. The sum runs over r = 0..k-1 in
// order. Indices outside [0, N) contribute nothing, so a bad index can never
// read outside the ring.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int K_MAX = 64;

template <bool VEC4>
__global__ void __launch_bounds__(THREADS)
topk_readout_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                    const float* __restrict__ values, int N, int k, int C,
                    float* __restrict__ out) {
  __shared__ int s_idx[K_MAX];
  __shared__ float s_w[K_MAX];
  const int q = blockIdx.x;
  if (threadIdx.x < k) {
    const int i = idx[(size_t)q * k + threadIdx.x];
    const bool in = i >= 0 && i < N;
    s_idx[threadIdx.x] = in ? i : 0;
    s_w[threadIdx.x] = in ? w[(size_t)q * k + threadIdx.x] : 0.f;
  }
  __syncthreads();
  if (VEC4) {
    const int c4 = blockIdx.y * THREADS + threadIdx.x;
    const int n4 = C / 4;
    if (c4 >= n4) return;
    const float4* v4 = reinterpret_cast<const float4*>(values);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < k; ++r) {
      const float wr = s_w[r];
      const float4 v = __ldg(&v4[(size_t)s_idx[r] * n4 + c4]);
      acc.x = fmaf(wr, v.x, acc.x);
      acc.y = fmaf(wr, v.y, acc.y);
      acc.z = fmaf(wr, v.z, acc.z);
      acc.w = fmaf(wr, v.w, acc.w);
    }
    reinterpret_cast<float4*>(out)[(size_t)q * n4 + c4] = acc;
  } else {
    const int c_end = min(C, ((int)blockIdx.y + 1) * THREADS * 4);
    for (int c = (int)blockIdx.y * THREADS * 4 + (int)threadIdx.x; c < c_end;
         c += THREADS) {
      float acc = 0.f;
      for (int r = 0; r < k; ++r)
        acc = fmaf(s_w[r], __ldg(&values[(size_t)s_idx[r] * C + c]), acc);
      out[(size_t)q * C + c] = acc;
    }
  }
}

}  // namespace

// idx/w: [Q, k]; values: [N, C]; out: [Q, C]. vec4 requires C % 4 == 0 and
// 16-byte aligned values/out. Returns the CUDA error code of the launch.
extern "C" int deva_topk_readout(const int* idx, const float* w,
                                 const float* values, int Q, int N, int k,
                                 int C, int vec4, float* out, void* stream) {
  if (Q <= 0 || N <= 0 || C <= 0 || k <= 0 || k > K_MAX ||
      (vec4 && C % 4 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(Q, (C + THREADS * 4 - 1) / (THREADS * 4));
  if (vec4)
    topk_readout_kernel<true><<<grid, THREADS, 0, st>>>(idx, w, values, N, k,
                                                        C, out);
  else
    topk_readout_kernel<false><<<grid, THREADS, 0, st>>>(idx, w, values, N,
                                                         k, C, out);
  return (int)cudaGetLastError();
}
