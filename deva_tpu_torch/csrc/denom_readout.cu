// Threshold softmax and readout of the approx path:
//
//   e[q, n]   = exp(sim[q, n] - rmax[q])  where sim[q, n] >= th[q], else 0
//   aff[q, n] = e[q, n] / max(sum_n e[q, n], 1e-30)
//   out[q, :] = sum_n aff[q, n] * V[n, :],   usage[n] = sum_q aff[q, n]
//
// Replaces the Pallas kernel `_denom_readout_kernel` (deva_tpu/ops/
// pallas_attention.py:491-575, reached by `_denom_readout_pass` from
// `attend_pallas_approx_multi`). rmax is the row max of the group maxima
// (clamped to 0 when not finite) and th the k-th largest group max; both
// come from segmax.cu's output, taken between the two kernels.
//
// The Pallas kernel sweeps every token twice (denominator, then a dense
// affinity tile times the value ring on the MXU): 2*Q*N*C multiply-adds,
// 56 GFLOP at the 480p shape (Q=1620, N=16712, C=1024), nearly all of them
// by zero. In f32 FFMA that would cost milliseconds. The support is sparse,
// and every entry >= th lies in a group whose max is >= th. So here:
//
// What bounds it on the H100: the gathered value rows, Q * |support| * C * 4
// bytes (about 0.2 to 0.8 GB at the 480p shape, where |support| is k to ~4k
// per row), partly from L2, and the latency of the row scans; the
// similarities recomputed for the candidate groups are a few hundred
// thousand FFMA per row.
//
// Design: one block per (query row, 1024-column chunk of V). The block scans
// its row of group maxima 256 groups at a time, compacts the groups with
// max >= th (a block-wide ballot prefix, so the order is fixed), and
// recomputes the similarities of their tokens with sim2.cuh's fmaf chain,
// the same float that segmax folded. Pass 1 sums the denominator; pass 2
// repeats the scan, writes each round's support (token, weight) to shared
// memory, gathers those value rows with 16-byte loads, and adds the weights
// to usage with atomics (from the first column chunk only). Every round
// holds at most 256 groups, so any support size is handled: ties among the
// group maxima may admit far more than 4k entries. A row with no valid token
// gets a zero denominator, clamped, and writes zeros.
#include "sim2.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KC_MAX = 128;
constexpr int GROUP_MAX = 4;
constexpr int ROUND = THREADS;                // group columns per round
constexpr int SLOTS = ROUND * GROUP_MAX;      // token slots per round
constexpr int COLS = 4 * THREADS;             // value columns per block
constexpr unsigned FULL = 0xffffffffu;

struct Smem {
  float q[KC_MAX];      // this row of qcat
  int groups[ROUND];    // the round's qualifying group columns
  int tok[SLOTS];       // the round's support tokens (pass 2)
  float w[SLOTS];       // and their weights
  int warp_count[WARPS];
  float red[WARPS];
};

// Rank of this thread's item among the block's items with pred set, in
// thread order; *total gets their number. Every thread must call it.
__device__ __forceinline__ int block_rank(bool pred, int* warp_count,
                                          int* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned bits = __ballot_sync(FULL, pred);
  if (lane == 0) warp_count[warp] = __popc(bits);
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = warp_count[w];
    before += w < warp ? c : 0;
    all += c;
  }
  __syncthreads();  // warp_count may be reused
  *total = all;
  return before + __popc(bits & ((1u << lane) - 1u));
}

// Token of member j of group column g: the strided partition of segmax.cu.
__device__ __forceinline__ int member_token(int g, int j, int n_tile,
                                            int width) {
  return (g / width) * n_tile + j * width + g % width;
}

template <bool HAS_QE, bool VEC4>
__global__ void __launch_bounds__(THREADS)
denom_readout_kernel(const float* __restrict__ qcat,
                     const float* __restrict__ mcat,
                     const float* __restrict__ bsq,
                     const float* __restrict__ msq,
                     const float* __restrict__ msv,
                     const uint8_t* __restrict__ valid,
                     const float* __restrict__ seg,
                     const float* __restrict__ rmax,
                     const float* __restrict__ th,
                     const float* __restrict__ values, int N, int kc,
                     int n_tile, int width, int groups, int nseg, int C,
                     float* __restrict__ out, float* __restrict__ usage) {
  __shared__ __align__(16) Smem s;
  const int tid = threadIdx.x;
  const int q = blockIdx.x;
  const int chunk = blockIdx.y;
  for (int c = tid; c < kc; c += THREADS) s.q[c] = qcat[(size_t)q * kc + c];
  const float sub_q = HAS_QE ? bsq[q] : 0.f;
  const float t = th[q];
  const float rm = rmax[q];
  const float* seg_row = seg + (size_t)q * nseg;
  __syncthreads();

  // e of token slot i of the round (0 if the slot is not in the support)
  auto slot_e = [&](int i, int n_slots, int* token) -> float {
    if (i >= n_slots) return 0.f;
    const int n = member_token(s.groups[i / groups], i % groups, n_tile,
                               width);
    *token = n;
    if (n >= N) return 0.f;
    const float acc = deva_sim2::dot_row(s.q, mcat + (size_t)n * kc, kc);
    const float sim = deva_sim2::finish(acc, HAS_QE ? sub_q : msq[n], msv[n],
                                        valid == nullptr || valid[n]);
    return (sim >= t && sim > -INFINITY) ? expf(sim - rm) : 0.f;
  };

  // pass 1: the denominator
  float den = 0.f;
  for (int g0 = 0; g0 < nseg; g0 += ROUND) {
    const int g = g0 + tid;
    const float gm = g < nseg ? seg_row[g] : -INFINITY;
    int n_groups;
    const int r = block_rank(gm >= t && gm > -INFINITY, s.warp_count,
                             &n_groups);
    if (gm >= t && gm > -INFINITY) s.groups[r] = g;
    __syncthreads();
    const int n_slots = n_groups * groups;
    for (int i = tid; i < n_slots; i += THREADS) {
      int n;
      den += slot_e(i, n_slots, &n);
    }
    __syncthreads();  // s.groups is rewritten by the next round
  }
  for (int off = 16; off > 0; off >>= 1)
    den += __shfl_xor_sync(FULL, den, off);
  if (tid % 32 == 0) s.red[tid / 32] = den;
  __syncthreads();
  den = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) den += s.red[w];
  const float inv_den = 1.f / fmaxf(den, 1e-30f);

  // pass 2: the support, round by round -> readout and usage
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int c4 = chunk * THREADS + tid;  // VEC4: this thread's float4 column
  for (int g0 = 0; g0 < nseg; g0 += ROUND) {
    const int g = g0 + tid;
    const float gm = g < nseg ? seg_row[g] : -INFINITY;
    int n_groups;
    const int r = block_rank(gm >= t && gm > -INFINITY, s.warp_count,
                             &n_groups);
    if (gm >= t && gm > -INFINITY) s.groups[r] = g;
    __syncthreads();
    const int n_slots = n_groups * groups;
    int count = 0;
    for (int i0 = 0; i0 < n_slots; i0 += THREADS) {
      int n = 0;
      const float e = slot_e(i0 + tid, n_slots, &n);
      int kept;
      const int pos = block_rank(e > 0.f, s.warp_count, &kept);
      if (e > 0.f) {
        s.tok[count + pos] = n;
        s.w[count + pos] = e * inv_den;
      }
      count += kept;
    }
    __syncthreads();
    if (chunk == 0)
      for (int i = tid; i < count; i += THREADS)
        atomicAdd(&usage[s.tok[i]], s.w[i]);
    if (VEC4) {
      if (c4 < C / 4) {
        const float4* v4 = reinterpret_cast<const float4*>(values);
        for (int i = 0; i < count; ++i) {
          const float wi = s.w[i];
          const float4 v = __ldg(&v4[(size_t)s.tok[i] * (C / 4) + c4]);
          acc.x = fmaf(wi, v.x, acc.x);
          acc.y = fmaf(wi, v.y, acc.y);
          acc.z = fmaf(wi, v.z, acc.z);
          acc.w = fmaf(wi, v.w, acc.w);
        }
      }
    } else {
      float* a = &acc.x;
      for (int i = 0; i < count; ++i) {
        const float wi = s.w[i];
        const float* row = values + (size_t)s.tok[i] * C;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = chunk * COLS + tid + j * THREADS;
          if (c < C) a[j] = fmaf(wi, __ldg(&row[c]), a[j]);
        }
      }
    }
    __syncthreads();  // s.groups, s.tok and s.w are rewritten next round
  }

  if (VEC4) {
    if (c4 < C / 4)
      reinterpret_cast<float4*>(out)[(size_t)q * (C / 4) + c4] = acc;
  } else {
    const float* a = &acc.x;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = chunk * COLS + tid + j * THREADS;
      if (c < C) out[(size_t)q * C + c] = a[j];
    }
  }
}

// sim2.cuh's similarity at given (q, idx[q, r]) pairs: the float the two
// kernels above see, for checking their support against another selection.
__global__ void sim2_at_kernel(const float* __restrict__ qcat,
                               const float* __restrict__ mcat,
                               const float* __restrict__ bsq,
                               const float* __restrict__ msq,
                               const float* __restrict__ msv,
                               const uint8_t* __restrict__ valid,
                               const int* __restrict__ idx, int Q, int N,
                               int kc, int k, float* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= Q * k) return;
  const int q = x / k, n = idx[x];
  if (n < 0 || n >= N) {
    out[x] = -INFINITY;
    return;
  }
  const float acc = deva_sim2::dot_row(qcat + (size_t)q * kc,
                                       mcat + (size_t)n * kc, kc);
  out[x] = deva_sim2::finish(acc, bsq != nullptr ? bsq[q] : msq[n], msv[n],
                             valid == nullptr || valid[n]);
}

template <bool HAS_QE, bool VEC4>
cudaError_t launch(const float* qcat, const float* mcat, const float* bsq,
                   const float* msq, const float* msv, const uint8_t* valid,
                   const float* seg, const float* rmax, const float* th,
                   const float* values, int Q, int N, int kc, int n_tile,
                   int width, int groups, int nseg, int C, float* out,
                   float* usage, cudaStream_t st) {
  const dim3 grid(Q, (C + COLS - 1) / COLS);
  denom_readout_kernel<HAS_QE, VEC4><<<grid, THREADS, 0, st>>>(
      qcat, mcat, bsq, msq, msv, valid, seg, rmax, th, values, N, kc, n_tile,
      width, groups, nseg, C, out, usage);
  return cudaGetLastError();
}

bool bad_operands(const float* bsq, const float* msq, int Q, int N, int kc,
                  int n_tile, int folds) {
  const bool has_qe = bsq != nullptr;
  return Q <= 0 || N <= 0 || kc <= 0 || kc > KC_MAX || kc % 4 != 0 ||
         folds < 0 || (1 << folds) > GROUP_MAX || n_tile <= 0 ||
         ((n_tile >> folds) << folds) != n_tile ||
         (has_qe ? msq != nullptr : msq == nullptr);
}

}  // namespace

// Operands as deva_segmax, plus seg [Q, nseg] (its output), rmax/th [Q],
// values [N, C]; out [Q, C]; usage [N], zeroed by the caller. vec4 requires
// C % 4 == 0 and 16-byte aligned values/out. qcat and mcat rows must be
// 16-byte aligned (kc % 4 == 0). Returns the CUDA error code of the launch.
extern "C" int deva_denom_readout(const float* qcat, const float* mcat,
                                  const float* bsq, const float* msq,
                                  const float* msv, const uint8_t* valid,
                                  const float* seg, const float* rmax,
                                  const float* th, const float* values, int Q,
                                  int N, int kc, int n_tile, int folds, int C,
                                  int vec4, float* out, float* usage,
                                  void* stream) {
  if (bad_operands(bsq, msq, Q, N, kc, n_tile, folds) || C <= 0 ||
      (vec4 && C % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const int width = n_tile >> folds;
  const int nseg = ((N + n_tile - 1) / n_tile) * width;
  const int groups = 1 << folds;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bsq != nullptr)
    err = vec4 ? launch<true, true>(qcat, mcat, bsq, msq, msv, valid, seg,
                                    rmax, th, values, Q, N, kc, n_tile, width,
                                    groups, nseg, C, out, usage, st)
               : launch<true, false>(qcat, mcat, bsq, msq, msv, valid, seg,
                                     rmax, th, values, Q, N, kc, n_tile,
                                     width, groups, nseg, C, out, usage, st);
  else
    err = vec4 ? launch<false, true>(qcat, mcat, bsq, msq, msv, valid, seg,
                                     rmax, th, values, Q, N, kc, n_tile,
                                     width, groups, nseg, C, out, usage, st)
               : launch<false, false>(qcat, mcat, bsq, msq, msv, valid, seg,
                                      rmax, th, values, Q, N, kc, n_tile,
                                      width, groups, nseg, C, out, usage, st);
  return (int)err;
}

// idx [Q, k] int32 -> out [Q, k]: the pair's similarity at those tokens.
extern "C" int deva_sim2_at(const float* qcat, const float* mcat,
                            const float* bsq, const float* msq,
                            const float* msv, const uint8_t* valid,
                            const int* idx, int Q, int N, int kc, int k,
                            float* out, void* stream) {
  if (bad_operands(bsq, msq, Q, N, kc, 128, 0) || k <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int total = Q * k;
  sim2_at_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      qcat, mcat, bsq, msq, msv, valid, idx, Q, N, kc, k, out);
  return (int)cudaGetLastError();
}
