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
// What bounds it on the H100: the f32 FFMA rate. At the 480p serving shape
// (Q=1620, N=16712 padded to 16896, kc=128) it is 3.5 G FFMA (6.9 GFLOP,
// 0.103 ms at 67 TFLOP/s) in true f32; the operands (8.7 MB of mcat) stay in
// L2, and the output is 27 MB.
//
// Design, SGEMM-shaped: a block of 256 threads owns 128 queries and 64
// consecutive group columns of one tile; each thread keeps a 4x8 register
// tile (queries ty + 32i, group columns tx + 8j), 12 16-byte shared loads
// per 128 FFMA. The qcat tile (all kc channels) is staged once and serves
// every member of the groups. mcat is staged token-major in chunks of KCH
// channels, double-buffered with cp.async: stage s+1 (the next chunk, or the
// next member's first) loads while stage s runs its FFMA. Both tiles are
// read as float4 along the channels, and their rows are padded so the
// 8-lane phases of a 16-byte shared load hit distinct banks. After a
// member's last chunk, each similarity is finished and folded into the
// running group max in registers. ~106 KB of shared memory and 117
// registers a thread: two blocks, 16 warps, per SM. The tile constants were
// picked by a sweep on the H100 at the 480p shapes (8x8 and 8x4 thread
// tiles, 64-query blocks, 16/32/64-channel stages; PERF.md). The similarity
// is sim2.cuh's fmaf chain over c = 0..kc-1 from 0.f, as in
// denom_readout.cu, so every group max is bitwise the max of the floats
// that kernel recomputes.
//
// A video axis (the batched propagator's B videos): the grid's z dimension
// is the video, whose operands start at qcat + b*Q*kc, mcat + b*N*kc,
// bsq + b*Q, msq/msv/valid + b*N and whose output starts at out +
// b*Q*nseg; each video's group maxima are bitwise those of its own launch.
#include <stdint.h>

#include "sim2.cuh"

namespace {

constexpr int QT = 128;       // queries per block
constexpr int GT = 64;        // group columns per block
constexpr int TI = 4;         // queries per thread
constexpr int TJ = 8;         // group columns per thread
constexpr int TY = QT / TI, TX = GT / TJ;
constexpr int THREADS = TX * TY;
constexpr int MIN_BLOCKS = 2;  // blocks per SM the registers must allow
constexpr int KC_MAX = 128;   // qcat / mcat channels (2 * Ck)
constexpr int KCH = 64;       // channels per mcat stage
constexpr int GROUP_MAX = 4;
constexpr int PAD = 4;

struct Smem {
  float a[QT][KC_MAX + PAD];      // qcat tile, query-major
  float b[2][GT][KCH + PAD];      // mcat stages, token-major
  float bsq[QT];
  float msq[GROUP_MAX][GT];
  float msv[GROUP_MAX][GT];
  int flag[GROUP_MAX][GT];        // 1 valid; 0 invalid or past the ring
};

// 16 bytes global -> shared, asynchronously; zeros when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

template <bool HAS_QE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
segmax_kernel(const float* __restrict__ qcat, const float* __restrict__ mcat,
              const float* __restrict__ bsq, const float* __restrict__ msq,
              const float* __restrict__ msv,
              const uint8_t* __restrict__ valid, int Q, int N, int kc,
              int n_tile, int width, int groups, int nseg,
              float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  // this block's video
  const size_t b = blockIdx.z;
  qcat += b * Q * kc;
  mcat += b * N * kc;
  if (HAS_QE) bsq += b * Q; else msq += b * N;
  msv += b * N;
  if (valid != nullptr) valid += b * N;
  out += b * Q * nseg;

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int q0 = blockIdx.x * QT;
  const int col0 = blockIdx.y * GT;
  const int tok0 = (col0 / width) * n_tile + col0 % width;
  const int kc4 = kc / 4;
  const int chunks = (kc + KCH - 1) / KCH;
  const int stages = groups * chunks;  // (member, channel chunk) in order

  for (int x = tid; x < QT * kc4; x += THREADS) {
    const int ql = x / kc4, c4 = x % kc4, q = q0 + ql;
    cp_async16(&s.a[ql][c4 * 4], qcat + (size_t)(q < Q ? q : 0) * kc + c4 * 4,
               q < Q);
  }
  auto load_stage = [&](int st) {
    const int k0 = (st % chunks) * KCH;
    const int kw4 = min(KCH, kc - k0) / 4;
    const int base = tok0 + (st / chunks) * width;
    for (int x = tid; x < GT * kw4; x += THREADS) {
      const int nl = x / kw4, c4 = x % kw4, n = base + nl;
      cp_async16(&s.b[st & 1][nl][c4 * 4],
                 mcat + (size_t)(n < N ? n : 0) * kc + k0 + c4 * 4, n < N);
    }
  };
  load_stage(0);
  cp_commit();  // group 0: the qcat tile and stage 0

  for (int x = tid; x < QT; x += THREADS)
    s.bsq[x] = (HAS_QE && q0 + x < Q) ? bsq[q0 + x] : 0.f;
  for (int x = tid; x < groups * GT; x += THREADS) {
    const int member = x / GT, nl = x % GT;
    const int n = tok0 + member * width + nl;
    const bool present = n < N;
    s.msv[member][nl] = present ? msv[n] : 0.f;
    s.msq[member][nl] = (!HAS_QE && present) ? msq[n] : 0.f;
    s.flag[member][nl] = present && (valid == nullptr || valid[n]);
  }

  float acc[TI][TJ], gmax[TI][TJ];
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      acc[i][j] = 0.f;
      gmax[i][j] = -INFINITY;
    }

  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {
      load_stage(st + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // stage st (and the qcat tile) visible to all
    const int k0 = (st % chunks) * KCH;
    const int kw = min(KCH, kc - k0);
    const float(*b)[KCH + PAD] = s.b[st & 1];
#pragma unroll
    for (int c = 0; c < KCH; c += 4) {
      if (c < kw) {
        float4 a[TI];
#pragma unroll
        for (int i = 0; i < TI; ++i)
          a[i] = *reinterpret_cast<const float4*>(&s.a[ty + TY * i][k0 + c]);
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          const float4 bv =
              *reinterpret_cast<const float4*>(&b[tx + TX * j][c]);
#pragma unroll
          for (int i = 0; i < TI; ++i) {
            acc[i][j] = deva_sim2::acc_step(acc[i][j], a[i].x, bv.x);
            acc[i][j] = deva_sim2::acc_step(acc[i][j], a[i].y, bv.y);
            acc[i][j] = deva_sim2::acc_step(acc[i][j], a[i].z, bv.z);
            acc[i][j] = deva_sim2::acc_step(acc[i][j], a[i].w, bv.w);
          }
        }
      }
    }
    if (st % chunks == chunks - 1) {  // a member's chain is complete
      const int member = st / chunks;
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          const int nl = tx + TX * j;
          const float sub = HAS_QE ? s.bsq[ty + TY * i] : s.msq[member][nl];
          const float sim = deva_sim2::finish(acc[i][j], sub,
                                              s.msv[member][nl],
                                              s.flag[member][nl] != 0);
          gmax[i][j] = fmaxf(gmax[i][j], sim);
          acc[i][j] = 0.f;
        }
    }
    __syncthreads();  // buffer st & 1 is refilled by stage st + 2
  }

#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int q = q0 + ty + TY * i;
    if (q < Q) {
      float* orow = out + (size_t)q * nseg + col0 + tx;
#pragma unroll
      for (int j = 0; j < TJ; ++j) orow[TX * j] = gmax[i][j];
    }
  }
}

}  // namespace

// B videos (B = 1: one): qcat [B, Q, kc], mcat [B, N, kc], msv [B, N];
// with a selection (has_qe) bsq [B, Q] and msq null, without one msq [B, N]
// and bsq null; valid [B, N] or null. qcat and mcat 16-byte aligned, kc % 4
// == 0. out [B, Q, nseg] with nseg = ceil(N / n_tile) * (n_tile >> folds).
// Returns the CUDA error code of the launch.
extern "C" int deva_segmax(const float* qcat, const float* mcat,
                           const float* bsq, const float* msq,
                           const float* msv, const uint8_t* valid, int B,
                           int Q, int N, int kc, int n_tile, int folds,
                           float* out, void* stream) {
  const int width = folds >= 0 && folds <= 2 ? n_tile >> folds : 0;
  const bool has_qe = bsq != nullptr;
  if (B <= 0 || B > 65535 || Q <= 0 || N <= 0 || kc <= 0 || kc > KC_MAX ||
      kc % 4 != 0 ||
      width <= 0 || width % GT != 0 || (width << folds) != n_tile ||
      (has_qe ? msq != nullptr : msq == nullptr) ||
      reinterpret_cast<uintptr_t>(qcat) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(mcat) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = (N + n_tile - 1) / n_tile;
  const int nseg = tiles * width;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(Smem);
  const dim3 grid((Q + QT - 1) / QT, nseg / GT, B);
  auto kernel = has_qe ? segmax_kernel<true> : segmax_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, st>>>(qcat, mcat, bsq, msq, msv, valid, Q, N,
                                      kc, n_tile, width, 1 << folds, nseg,
                                      out);
  return (int)cudaGetLastError();
}
