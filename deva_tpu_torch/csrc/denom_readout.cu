// Threshold softmax and readout of the approx path:
//
//   rmax[q]   = max_g seg[q, g]           (0 when not finite)
//   th[q]     = the min(k, nseg)-th largest seg[q, g]
//   e[q, n]   = exp(sim[q, n] - rmax[q])  where sim[q, n] >= th[q], else 0
//   aff[q, n] = e[q, n] / max(sum_n e[q, n], 1e-30)
//   out[q, :] = sum_n aff[q, n] * V[n, :],   usage[n] = sum_q aff[q, n]
//
// Replaces the Pallas kernel `_denom_readout_kernel` (deva_tpu/ops/
// pallas_attention.py:491-575, reached by `_denom_readout_pass` from
// `attend_pallas_approx_multi`), and the row max and k-th largest group max
// that deva_tpu takes between its two kernels (pallas_attention.py:627-643).
// seg is segmax.cu's output, the group maxima.
//
// The Pallas kernel sweeps every token twice (denominator, then a dense
// affinity tile times the value ring on the MXU): 2*Q*N*C multiply-adds,
// 56 GFLOP at the 480p shape (Q=1620, N=16712, C=1024), nearly all of them
// by zero. The support is sparse, and every entry >= th lies in a group
// whose max is >= th, so here the support is found from the group maxima.
//
// What bounds it on the H100: the bytes it must move, the row of group
// maxima (nseg*4 bytes per query, 27 MB at the 480p shape) and the value rows
// of the support (k to k+5 rows of C*4 bytes per query on that data, mostly
// from L2). The similarities recomputed for the support are ~0.2 GFLOP.
//
// Design: one warp owns one query row, several rows to a block, and does no
// block-wide synchronisation.
// - It reads its row of group maxima with coalesced 16-byte loads and takes
//   the row max and each lane's max. For k <= 32 the k-th largest lane max
//   is a lower bound on th (k distinct entries reach it); a second read of
//   the row (from L2) compacts the entries at or above it, in group order,
//   into a candidate list in shared memory (~2% of the row at the 480p
//   shape). A list that overflows CCAP, or k > 32, falls back to the whole
//   row in device memory.
// - th is the exact k-th largest group max: a radix select over the
//   order-preserving uint32 key of the float, 8 bits a pass, with a
//   256-bin histogram per warp (warp-aggregated shared atomics), over the
//   candidates. The k-th largest key is unique, so th is bitwise
//   torch.topk's k-th value. A caller may pass th instead (th_in: then the
//   candidates are the entries >= th_in), and the kernel writes the rmax and
//   th it used.
// - The qualifying groups (max >= th and > -inf) are compacted from the
//   candidates with ballot prefixes, in group order, up to GCAP a round.
//   Their tokens' similarities are recomputed ILP to a lane, each with
//   sim2.cuh's fmaf chain over c = 0..kc-1 from 0.f: bitwise the float
//   segmax folded, so the support contains the exact top-k. The (token, e)
//   pairs with e > 0 stay in shared memory, and the denominator is summed in
//   a fixed order.
// - Readout: each lane takes VPL float4 columns of every support row per
//   1024-column block, from the cached list; usage takes one atomic per
//   (query, token).
// A support that fits one round (the rule: k to k+5 groups) is found once.
// A larger one (ties among the group maxima may admit far more than 4k
// entries) takes rounds: the denominator over all of them, then again,
// round by round, for the readout. A row with no valid token gets a zero
// denominator, clamped, and writes zeros.
//
// A video axis (the batched propagator's B videos): the grid's y dimension
// is the video b. Query q of video b reads and writes the query-side rows
// b*Q + q (qcat, bsq, seg, th_in, out, rmax, th) and token n of its ring
// the token-side rows b*N + n (mcat, msq, msv, valid, values, usage), so
// its usage atomics go to its own row. Each video runs the single-video
// code: its rmax and th are bitwise those of its own launch, its output and
// usage equal to them up to the order of the usage atomics. The rows are
// 32-bit indices, as the single-video code's were, and the pointers stay
// kernel parameters: offsetting each pointer, or 64-bit row offsets, took
// more registers in the 16-byte instances, and the lost occupancy slowed
// the single-video launch on the H100 (PERF.md).
//
// The value ring is float or bf16 (ring.cuh), one template instance each.
// On bf16 the normalised weight aff = e * inv is rounded to bf16 before the
// product, as the Pallas kernel casts its normalised affinity tile
// (pallas_attention.py:524-532), not e; the usage sums the f32 aff. A lane
// then takes VPL 16-byte vectors of 8 columns, so a column block is 1024
// columns for both types, and the value bytes of the support halve. rmax,
// th and the support never touch the values: they are bitwise those of the
// float instance.
#include "ring.cuh"
#include "sim2.cuh"

namespace {

using deva_ring::bf16;

constexpr int KC_MAX = 128;
constexpr int GROUP_MAX = 4;
constexpr int GCAP = 64;                  // qualifying groups per round
constexpr int SCAP = GCAP * GROUP_MAX;    // token slots per round
constexpr int ILP = 4;                    // similarities in flight per lane
constexpr int VPL = 8;  // float4 value vectors per lane per column block
constexpr int CCAP = 512;                 // candidate group maxima
constexpr int ROWS = 2;  // query rows (warps) per block: 1..8 moved the
                         // 480p-shape time by <= 9% on the H100
constexpr int BINS = 256;
// shared words per warp: q, the histogram, the round's groups, its tokens
// and weights, the candidates' indices and values
constexpr int WARP_WORDS = KC_MAX + BINS + GCAP + 2 * SCAP + 2 * CCAP;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Token of member j of group column g: the strided partition of segmax.cu.
__device__ __forceinline__ int member_token(int g, int j, int n_tile,
                                            int width) {
  return (g / width) * n_tile + j * width + g % width;
}

// The kk-th largest of row[0, nseg) (1 <= kk <= nseg), by its order key,
// four passes of 8 bits. Every lane of the warp calls it and gets the value.
__device__ float kth_largest(const float* row, int nseg, unsigned kk,
                             unsigned* hist, int lane) {
  unsigned prefix = 0u, mask = 0u, remaining = kk;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = lane; b < BINS; b += 32) hist[b] = 0u;
    __syncwarp();
    for (int i0 = 0; i0 < nseg; i0 += 32) {
      const int i = i0 + lane;
      const unsigned key = i < nseg ? order_key(row[i]) : 0u;
      const bool hit = i < nseg && (key & mask) == prefix;
      const unsigned digit = hit ? (key >> shift) & 255u : 256u;
      const unsigned peers = __match_any_sync(FULL, digit);
      if (hit && lane == __ffs(peers) - 1)
        atomicAdd(&hist[digit], (unsigned)__popc(peers));
    }
    __syncwarp();
    // lane owns digits 255 - 8*lane - j, j = 0..7: highest first
    unsigned c[8], mine = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = hist[255 - 8 * lane - j];
      mine += c[j];
    }
    unsigned incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned o = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += o;
    }
    unsigned before = incl - mine, rest = 0u;
    int found = -1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (found < 0 && before < remaining && before + c[j] >= remaining) {
        found = 255 - 8 * lane - j;
        rest = remaining - before;
      }
      before += c[j];
    }
    const int src = __ffs(__ballot_sync(FULL, found >= 0)) - 1;
    prefix |= (unsigned)__shfl_sync(FULL, found, src) << shift;
    remaining = __shfl_sync(FULL, rest, src);
    mask |= 255u << shift;
    __syncwarp();  // the histogram is cleared by the next pass
  }
  return key_float(prefix);
}

template <bool HAS_QE, bool VEC16, typename T>
__global__ void __launch_bounds__(32 * ROWS)
denom_readout_kernel(const float* __restrict__ qcat,
                     const float* __restrict__ mcat,
                     const float* __restrict__ bsq,
                     const float* __restrict__ msq,
                     const float* __restrict__ msv,
                     const uint8_t* __restrict__ valid,
                     const float* __restrict__ seg,
                     const float* __restrict__ th_in,
                     const T* __restrict__ values, int Q, int N, int kc,
                     int n_tile, int width, int groups, int nseg, int C,
                     int kk, float* __restrict__ out,
                     float* __restrict__ usage, float* __restrict__ rmax_out,
                     float* __restrict__ th_out) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int q = blockIdx.x * ROWS + warp;
  if (q >= Q) return;  // the whole warp: no block-wide barrier follows
  // this block's video: its query-side row and its ring's first token row
  const int qrow = blockIdx.y * Q + q;
  const int n0 = blockIdx.y * N;
  float* s_q = smem + (size_t)warp * WARP_WORDS;
  unsigned* hist = reinterpret_cast<unsigned*>(s_q + KC_MAX);
  int* glist = reinterpret_cast<int*>(hist + BINS);
  int* tok = glist + GCAP;
  float* w = reinterpret_cast<float*>(tok + SCAP);
  int* cidx = reinterpret_cast<int*>(w + SCAP);
  float* cval = reinterpret_cast<float*>(cidx + CCAP);
  const unsigned lt = (1u << lane) - 1u;

  for (int c = lane; c < kc; c += 32) s_q[c] = qcat[(size_t)qrow * kc + c];
  // the row max and each lane's max
  const float* row = seg + (size_t)qrow * nseg;
  const float4* row4 = reinterpret_cast<const float4*>(row);
  float lmax = -INFINITY;
  for (int i = lane; i < nseg / 4; i += 32) {
    const float4 v = __ldg(&row4[i]);
    lmax = fmaxf(lmax, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
  }
  float mx = lmax;
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
  const float rm = isfinite(mx) ? mx : 0.f;

  // a lower bound on th: th_in, or the kk-th largest lane max
  float lo = -INFINITY;
  if (th_in != nullptr) {
    lo = th_in[qrow];
  } else if (kk <= 32) {
    int above = 0;  // lane maxima ahead of this lane's, ties by lane
    for (int l = 0; l < 32; ++l) {
      const float o = __shfl_sync(FULL, lmax, l);
      above += o > lmax || (o == lmax && l < lane);
    }
    const int src = __ffs(__ballot_sync(FULL, above == kk - 1)) - 1;
    lo = __shfl_sync(FULL, lmax, src);
  }
  // the candidates: the entries >= lo, in order, unless more than CCAP
  int ncand = 0;
  bool over = false;
  for (int i0 = 0; i0 < nseg; i0 += 32) {
    const int i = i0 + lane;
    const float v = i < nseg ? __ldg(&row[i]) : -INFINITY;
    const bool pred = i < nseg && v >= lo;
    const unsigned bits = __ballot_sync(FULL, pred);
    if (ncand + __popc(bits) > CCAP) {
      over = true;
      break;
    }
    if (pred) {
      const int p = ncand + __popc(bits & lt);
      cidx[p] = i;
      cval[p] = v;
    }
    ncand += __popc(bits);
  }
  __syncwarp();
  const float t = th_in != nullptr ? lo
                  : over ? kth_largest(row, nseg, kk, hist, lane)
                         : kth_largest(cval, ncand, kk, hist, lane);
  if (lane == 0) {
    rmax_out[qrow] = rm;
    th_out[qrow] = t;
  }
  const float sub_q = HAS_QE ? bsq[qrow] : 0.f;
  const float4* q4 = reinterpret_cast<const float4*>(s_q);

  // the qualifying groups from position *pos of the candidates (the row when
  // they overflowed) on, at most GCAP, into glist; *pos moves past them in
  // steps of 32
  const int len = over ? nseg : ncand;
  auto compact = [&](int* pos) -> int {
    int n = 0;
    while (*pos < len) {
      const int p = *pos + lane;
      const float gm = p >= len ? -INFINITY : over ? __ldg(&row[p]) : cval[p];
      const bool pred = gm >= t && gm > -INFINITY;
      const unsigned bits = __ballot_sync(FULL, pred);
      if (n + __popc(bits) > GCAP) break;
      if (pred) glist[n + __popc(bits & lt)] = over ? p : cidx[p];
      n += __popc(bits);
      *pos += 32;
    }
    __syncwarp();
    return n;
  };

  // e of the tokens of n_groups groups of glist -> (tok, w) with e > 0, in
  // slot order; each lane adds its e to *den in a fixed order. Returns the
  // list's length.
  auto gather = [&](int n_groups, float* den) -> int {
    const int n_slots = n_groups * groups;
    int count = 0;
    for (int s0 = 0; s0 < n_slots; s0 += 32 * ILP) {
      int tk[ILP];
      bool live[ILP];
      const float4* m4[ILP];
#pragma unroll
      for (int j = 0; j < ILP; ++j) {
        const int s = s0 + j * 32 + lane;
        const int n = s < n_slots ? member_token(glist[s / groups],
                                                 s % groups, n_tile, width)
                                  : N;
        live[j] = n < N;
        tk[j] = n0 + (live[j] ? n : 0);  // the video's token row
        m4[j] = reinterpret_cast<const float4*>(mcat + (size_t)tk[j] * kc);
      }
      float acc[ILP];
#pragma unroll
      for (int j = 0; j < ILP; ++j) acc[j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < kc / 4; ++c) {
        const float4 a = q4[c];
#pragma unroll
        for (int j = 0; j < ILP; ++j) {
          const float4 b = __ldg(&m4[j][c]);
          acc[j] = deva_sim2::acc_step(acc[j], a.x, b.x);
          acc[j] = deva_sim2::acc_step(acc[j], a.y, b.y);
          acc[j] = deva_sim2::acc_step(acc[j], a.z, b.z);
          acc[j] = deva_sim2::acc_step(acc[j], a.w, b.w);
        }
      }
#pragma unroll
      for (int j = 0; j < ILP; ++j) {
        float e = 0.f;
        if (live[j]) {
          const int n = tk[j];
          const float sim = deva_sim2::finish(
              acc[j], HAS_QE ? sub_q : msq[n], msv[n],
              valid == nullptr || valid[n]);
          if (sim >= t && sim > -INFINITY) e = expf(sim - rm);
        }
        if (den != nullptr) *den += e;
        const unsigned bits = __ballot_sync(FULL, e > 0.f);
        if (e > 0.f) {
          const int p = count + __popc(bits & lt);
          tok[p] = tk[j];
          w[p] = e;
        }
        count += __popc(bits);
      }
    }
    __syncwarp();
    return count;
  };

  // the denominator: one round when the support fits, else all rounds
  float den = 0.f;
  int pos = 0, rounds = 0, count = 0;
  do {
    count = gather(compact(&pos), &den);
    ++rounds;
  } while (pos < len);
  for (int off = 16; off > 0; off >>= 1)
    den += __shfl_xor_sync(FULL, den, off);
  const float inv = 1.f / fmaxf(den, 1e-30f);

  // a lane's columns of a block: VL vectors of V elements (16 bytes each on
  // the vector path)
  constexpr int V = VEC16 ? deva_ring::kVec16<T> : 1;
  constexpr int VL = VPL * 4 / (VEC16 ? V : 4);
  constexpr int COLS = 32 * VL * V;  // value columns per column block
  for (int col0 = 0; col0 < C; col0 += COLS) {
    float acc[VL][V];
#pragma unroll
    for (int v = 0; v < VL; ++v)
#pragma unroll
      for (int x = 0; x < V; ++x) acc[v][x] = 0.f;
    pos = 0;
    do {
      if (rounds > 1)
        count = gather(compact(&pos), nullptr);
      else
        pos = len;
      if (col0 == 0)
        for (int i = lane; i < count; i += 32)
          atomicAdd(&usage[tok[i]], w[i] * inv);
#pragma unroll 2
      for (int i = 0; i < count; ++i) {
        const float wi = deva_ring::weight<T>(w[i] * inv);
        const T* vrow = values + (size_t)tok[i] * C;
#pragma unroll
        for (int v = 0; v < VL; ++v) {
          const int col = col0 + (v * 32 + lane) * V;
          if (col < C) {
            if constexpr (VEC16) {
              float x[V];
              deva_ring::ldg16(vrow + col, x);
#pragma unroll
              for (int e = 0; e < V; ++e)
                acc[v][e] = fmaf(wi, x[e], acc[v][e]);
            } else {
              acc[v][0] = fmaf(wi, deva_ring::ldg1(vrow + col), acc[v][0]);
            }
          }
        }
      }
      __syncwarp();  // the next round rewrites glist, tok and w
    } while (pos < len);
    float* orow = out + (size_t)qrow * C;
#pragma unroll
    for (int v = 0; v < VL; ++v) {
      const int col = col0 + (v * 32 + lane) * V;
      if (col < C) {
#pragma unroll
        for (int x = 0; x < V; x += 4) {
          if constexpr (VEC16)
            *reinterpret_cast<float4*>(orow + col + x) = make_float4(
                acc[v][x], acc[v][x + 1], acc[v][x + 2], acc[v][x + 3]);
          else
            orow[col] = acc[v][0];
        }
      }
    }
  }
}

// sim2.cuh's similarity at given (q, idx[q, r]) pairs: the float the two
// kernels see, for checking their support against another selection.
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

template <bool HAS_QE, bool VEC16, typename T>
cudaError_t launch(const float* qcat, const float* mcat, const float* bsq,
                   const float* msq, const float* msv, const uint8_t* valid,
                   const float* seg, const float* th_in, const void* values,
                   int B, int Q, int N, int kc, int n_tile, int width,
                   int groups, int nseg, int C, int kk, float* out,
                   float* usage, float* rmax, float* th, cudaStream_t st) {
  const size_t smem = (size_t)ROWS * WARP_WORDS * sizeof(float);
  auto kernel = denom_readout_kernel<HAS_QE, VEC16, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + ROWS - 1) / ROWS, B);
  kernel<<<grid, 32 * ROWS, smem, st>>>(
      qcat, mcat, bsq, msq, msv, valid, seg, th_in,
      static_cast<const T*>(values), Q, N, kc, n_tile, width, groups, nseg, C,
      kk, out, usage, rmax, th);
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

// B videos (B = 1: one): operands as deva_segmax, plus seg [B, Q, nseg]
// (its output), th_in [B, Q] or null, values [B, N, C] float (ring_bf16 =
// 0) or bf16 (1), k >= 1; out [B, Q, C]; usage [B, N], zeroed by the
// caller; rmax and th [B, Q], the row max and threshold used. vec selects
// the 16-byte path: it requires C % 4 == 0 (float) or C % 8 == 0 (bf16) and
// 16-byte aligned values/out. qcat and mcat rows must be 16-byte aligned (kc
// % 4 == 0), as must the rows of seg (nseg % 4 == 0). Returns the CUDA
// error code of the launch.
extern "C" int deva_denom_readout(
    const float* qcat, const float* mcat, const float* bsq, const float* msq,
    const float* msv, const uint8_t* valid, const float* seg,
    const float* th_in, const void* values, int ring_bf16, int B, int Q,
    int N, int kc, int n_tile, int folds, int C, int k, int vec, float* out,
    float* usage, float* rmax, float* th, void* stream) {
  if (bad_operands(bsq, msq, Q, N, kc, n_tile, folds) || B <= 0 ||
      B > 65535 || (long long)B * Q > INT32_MAX ||
      (long long)B * N > INT32_MAX || C <= 0 || k <= 0 ||
      (ring_bf16 != 0 && ring_bf16 != 1) ||
      (vec && C % (ring_bf16 ? 8 : 4) != 0))
    return (int)cudaErrorInvalidValue;
  const int width = n_tile >> folds;
  const int nseg = ((N + n_tile - 1) / n_tile) * width;
  if (nseg % 4 != 0) return (int)cudaErrorInvalidValue;
  const int groups = 1 << folds;
  const int kk = k < nseg ? k : nseg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool has_qe = bsq != nullptr;
  auto go = ring_bf16 ? (has_qe ? (vec ? launch<true, true, bf16>
                                         : launch<true, false, bf16>)
                                  : (vec ? launch<false, true, bf16>
                                         : launch<false, false, bf16>))
                      : (has_qe ? (vec ? launch<true, true, float>
                                       : launch<true, false, float>)
                                : (vec ? launch<false, true, float>
                                       : launch<false, false, float>));
  return (int)go(qcat, mcat, bsq, msq, msv, valid, seg, th_in, values, B, Q,
                 N, kc, n_tile, width, groups, nseg, C, kk, out, usage, rmax,
                 th, st);
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
