// Group maxima of the approx similarity, without the dense [Q, N] matrix in
// device memory.
//
// Replaces the Pallas kernel `_segmax_kernel` (deva_tpu/ops/
// pallas_attention.py:451-488, reached by `_segmax_pass` from
// `attend_pallas_approx_multi`).
//
// The token axis (the concatenated [long-term ; working] rings) is cut into
// tiles of n_tile tokens, padded with -inf past the end. Within a tile,
// group g (0 <= g < W = n_tile >> folds) is {g, g+W, g+2W, ...}: 2^folds
// tokens a stride W apart, which is what folding the tile in half `folds`
// times gives. out[q, t*W + g] is the max of sim[q, .] over group g of tile
// t, so the row max of out is the exact row max, and the k-th largest entry
// of a row is a lower bound on the row's k-th similarity. The partition
// decides the threshold, so it is reproduced exactly (segmax_plain in
// ops/approx_kernels.py builds the same one).
//
// What bounds it on the H100: like sim_topk, the f32 FFMA rate and the
// shared-memory traffic of the register tiles. At the 480p serving shape
// (Q=1620, N=16712 padded to 16896, kc=128) it is 3.5 G FFMA in true f32;
// the operands (8.7 MB of mcat) stay in L2, and the output is 27 MB.
//
// Design: a block owns 64 queries and 64 consecutive group columns of one
// tile. For each of the 2^folds members j of its groups it stages the 64
// tokens tile*n_tile + j*W + [w0, w0+64) in shared memory (channel-major,
// rows padded by 4 floats against bank conflicts), computes a 64x64 block
// of similarities with 4x4 register tiles per thread, and keeps the running
// max in registers, so the fold costs no memory traffic. The similarity is
// built by sim2.cuh, shared with denom_readout.cu.
#include "sim2.cuh"

namespace {

constexpr int QT = 64;        // queries per block
constexpr int GT = 64;        // group columns per block
constexpr int KC_MAX = 128;   // qcat / mcat channels (2 * Ck)
constexpr int THREADS = 256;  // 16 x 16 threads, 4x4 similarities each
constexpr int PAD = 4;

struct Smem {
  float a[KC_MAX][QT];        // qcat tile, channel-major
  float m[KC_MAX][GT + PAD];  // mcat tile, channel-major
  float bsq[QT];
  float msq[GT];
  float msv[GT];
  int flag[GT];               // 1 valid; 0 invalid or past the ring
};

template <bool HAS_QE>
__global__ void __launch_bounds__(THREADS)
segmax_kernel(const float* __restrict__ qcat, const float* __restrict__ mcat,
              const float* __restrict__ bsq, const float* __restrict__ msq,
              const float* __restrict__ msv,
              const uint8_t* __restrict__ valid, int Q, int N, int kc,
              int n_tile, int width, int groups, int nseg,
              float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * QT;
  const int col0 = blockIdx.y * GT;
  const int tok0 = (col0 / width) * n_tile + col0 % width;

  for (int x = tid; x < QT * kc; x += THREADS) {
    const int ql = x / kc, c = x % kc, q = q0 + ql;
    s.a[c][ql] = q < Q ? qcat[(size_t)q * kc + c] : 0.f;
  }
  for (int x = tid; x < QT; x += THREADS)
    s.bsq[x] = (HAS_QE && q0 + x < Q) ? bsq[q0 + x] : 0.f;

  float gmax[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) gmax[i][j] = -INFINITY;

  for (int member = 0; member < groups; ++member) {
    const int base = tok0 + member * width;
    __syncthreads();  // the previous member's tile has been read
    for (int x = tid; x < GT * kc; x += THREADS) {
      const int nl = x / kc, c = x % kc, n = base + nl;
      s.m[c][nl] = n < N ? mcat[(size_t)n * kc + c] : 0.f;
    }
    for (int x = tid; x < GT; x += THREADS) {
      const int n = base + x;
      const bool present = n < N;
      s.msv[x] = present ? msv[n] : 0.f;
      s.msq[x] = (!HAS_QE && present) ? msq[n] : 0.f;
      s.flag[x] = present && (valid == nullptr || valid[n]);
    }
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kc; ++c) {
      const float4 a4 = *reinterpret_cast<const float4*>(&s.a[c][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&s.m[c][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = deva_sim2::acc_step(acc[i][j], av[i], bv[j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nl = tx * 4 + j;
        const float sub = HAS_QE ? s.bsq[ty * 4 + i] : s.msq[nl];
        const float sim =
            deva_sim2::finish(acc[i][j], sub, s.msv[nl], s.flag[nl] != 0);
        gmax[i][j] = fmaxf(gmax[i][j], sim);
      }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty * 4 + i;
    if (q < Q)
      *reinterpret_cast<float4*>(&out[(size_t)q * nseg + col0 + tx * 4]) =
          make_float4(gmax[i][0], gmax[i][1], gmax[i][2], gmax[i][3]);
  }
}

}  // namespace

// qcat [Q, kc], mcat [N, kc], msv [N]; with a selection (has_qe) bsq [Q] and
// msq null, without one msq [N] and bsq null; valid [N] or null. out [Q,
// nseg] with nseg = ceil(N / n_tile) * (n_tile >> folds). Returns the CUDA
// error code of the launch.
extern "C" int deva_segmax(const float* qcat, const float* mcat,
                           const float* bsq, const float* msq,
                           const float* msv, const uint8_t* valid, int Q,
                           int N, int kc, int n_tile, int folds, float* out,
                           void* stream) {
  const int width = folds >= 0 && folds <= 2 ? n_tile >> folds : 0;
  const bool has_qe = bsq != nullptr;
  if (Q <= 0 || N <= 0 || kc <= 0 || kc > KC_MAX || kc % 4 != 0 ||
      width <= 0 || width % GT != 0 || (width << folds) != n_tile ||
      (has_qe ? msq != nullptr : msq == nullptr))
    return (int)cudaErrorInvalidValue;
  const int tiles = (N + n_tile - 1) / n_tile;
  const int nseg = tiles * width;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(Smem);
  const dim3 grid((Q + QT - 1) / QT, nseg / GT);
  cudaError_t err;
  if (has_qe) {
    err = cudaFuncSetAttribute(segmax_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    segmax_kernel<true><<<grid, THREADS, smem, st>>>(
        qcat, mcat, bsq, msq, msv, valid, Q, N, kc, n_tile, width,
        1 << folds, nseg, out);
  } else {
    err = cudaFuncSetAttribute(segmax_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    segmax_kernel<false><<<grid, THREADS, smem, st>>>(
        qcat, mcat, bsq, msq, msv, valid, Q, N, kc, n_tile, width,
        1 << folds, nseg, out);
  }
  return (int)cudaGetLastError();
}
