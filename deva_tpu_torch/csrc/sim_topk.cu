// Exact masked top-k of the anisotropic-L2 memory similarity, without the
// dense [Q, N] similarity in device memory.
//
// Replaces the Pallas kernel `_sim_topk_kernel` and its XLA candidate merge
// (deva_tpu/ops/pallas_attention.py:177-242, reached by `sim_topk`).
//
//   sim[q, n] = (2 * (qk*qe)[q] . mk[n] - qe[q] . mk[n]^2 - bsq[q]) * msv[n]
//
// with bsq[q] = sum_c qe*qk^2, msv[n] = ms[n] / d (d: the f32 sqrt(Ck) that
// the plain path divides by) and -inf on invalid ring slots. Without a
// selection (qe == nullptr) the a^2 term is msq[n] = sum_c mk^2 and bsq is
// zero. The result per query is the k best (value, index) pairs, ordered by
// value descending and then index ascending: ties go to the lowest index, as
// with lax.top_k and a stable descending sort.
//
// What bounds it on the H100: the similarity is 2*Q*N*Ck FFMAs in true f32
// (no TF32, no tensor cores: near-tie rankings must not flip). At the 480p
// serving shape (Q=1620, N=16712, Ck=64) that is 3.5 G FFMA; the keys are
// 4.3 MB and stay in L2. So the kernel is bound by the f32 FFMA rate and the
// shared-memory traffic of its register tiles, and, at small N, by the
// selection: a running top-k over a random stream of L tokens takes about
// k*(1 + ln(L/k)) entries, most of them in its first tiles.
//
// Design:
// - One call is two kernels and nothing else: the selection kernel reads
//   qk, qe, mk, ms and valid as they are. A block computes qk*qe and
//   bsq (a fixed-order sum over c of the rounded products qe*qk*qk) on its
//   query load, msq (the same over mk*mk) on each token-tile load, and msv
//   by IEEE division, not by a reciprocal.
// - Similarity: a block owns QT=64 queries and one contiguous split of the
//   token axis, which it streams through shared memory in NT=64-token tiles.
//   256 threads each compute a 4x4 register tile per token tile: two fmaf
//   chains over c in order (ab, sq), then (2*ab - a_sq - bsq) * msv.
// - Selection, batched and warp-parallel (the WarpSelect of Johnson, Douze
//   & Jegou, "Billion-scale similarity search with GPUs", 2017). Each query
//   keeps a sorted list of 64 entries in shared memory, of which the first
//   k are its running top-k and the rest (-inf, NO_INDEX) sentinels. Warp w
//   owns queries 8w..8w+7. For each of its rows of a similarity tile it
//   holds the row's 64 candidates in registers (entries 2*lane and
//   2*lane+1) and filters them with one ballot against the list's k-th
//   entry. With more than FEW survivors it sorts the 64 (non-survivors
//   as sentinels) with a bitonic network of __shfl_xor_sync
//   compare-exchanges and merges them into the list with a bitonic merge;
//   with 1..FEW survivors it places each entry at its rank in the union
//   (one shuffle and two ballots per survivor, the list in registers). The
//   first tiles of a split take the sort, the later ones mostly the ranks.
//   On the H100, at Q=1620, k=30 and the wrapper's split plan, FEW=8 was
//   the fastest of 0, 1, 2, 4, 8, 16, 64 at ring sizes 3240 to 16712 and
//   within 0.2% of it at 1620 (4: up to 3% slower). Sort only (0) was 15%
//   slower at N=16712; ranks only (64) 30% slower there and 2.5x slower at
//   N=1620, where every row of the first tiles has many survivors
//   (PERF.md).
// - Every comparison is better(): value descending, then index ascending,
//   a total order on real entries. Invalid slots take part as -inf with
//   their own index, so a row with fewer valid tokens than k gets in-range
//   indices for its -inf slots (the lowest invalid ones), exactly as the
//   plain sorted version does. Token slots past the end never take part.
// - Splitting the token axis gives the card enough blocks at Q=1620 (26
//   query tiles alone would leave most of the 132 SMs idle); the wrapper
//   chooses the split plan (_sim_topk_plan). A second kernel merges the
//   per-split lists, one warp per query, with the same bitonic merge. The
//   top k of a totally ordered set are unique, and every similarity is the
//   same float in any block, so the result is bitwise the same under any
//   plan.
// - cudaFuncSetAttribute runs once per template instance and device.
// - A video axis (the batched propagator's B videos in lockstep): the grid's
//   z dimension (the merge kernel's y) is the video, whose tensors start at
//   qk + b*Q*Ck, mk + b*N*Ck, ms/valid + b*N and its scratch at
//   b*splits*Q*k. Each video runs the single-video code on its own bases,
//   so its result is bitwise that of its own launch. B = 1 is the
//   single-video call.
// - The ring (mk, ms) is float or bf16 (ring.cuh), one template instance
//   each. A bf16 key is widened as its tile is loaded into the same f32
//   shared-memory tile, exactly, so the key bytes per tile halve and every
//   similarity, and with it the result, is bitwise that of the f32 kernel
//   on the widened ring.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "ring.cuh"

namespace {

using deva_ring::bf16;
using deva_ring::widen;

constexpr int QT = 64;        // queries per block
constexpr int NT = 64;        // tokens per shared-memory tile
constexpr int CK_MAX = 64;    // key channels
constexpr int K_MAX = 64;     // bound on k: a list is 64 entries, 2 per lane
constexpr int THREADS = 256;  // 16 x 16 threads, 4x4 similarities each
constexpr int ROWS_PER_WARP = QT / (THREADS / 32);
constexpr int MAX_SPLITS = 32;
constexpr int MERGE_WARPS = 4;  // queries per block of the merge kernel
constexpr int FEW = 8;  // most survivors of a tile row merged by rank
// Rows of the channel-major tiles are padded by 4 floats: a tile is stored
// transposed (consecutive threads write consecutive channels), and with
// unpadded 64-float rows all 32 stores of a warp hit one bank. Padded, they
// spread over 8 banks, and the float4 reads stay 16-byte aligned.
constexpr int PAD = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_INDEX = 0x7fffffff;

// 101 KB, so that two blocks fit on an SM (228 KB): the similarity tile and
// the query staging share their space with the token tile.
struct Smem {
  float a[CK_MAX][QT + PAD];  // qk*qe (qk without a selection), by channel
  float e[CK_MAX][QT + PAD];  // qe, by channel
  union {
    float qk[CK_MAX][QT + PAD];      // qk, for bsq, before the first tile
    struct {
      float m[CK_MAX][NT + PAD];     // mk tile, channel-major
      float m2[CK_MAX][NT + PAD];    // mk^2 tile
    } tile;
    float sim[QT][NT + PAD];         // the tile's similarities
  } u;
  float list_v[QT][K_MAX];
  int list_i[QT][K_MAX];
  float bsq[QT];
  float msv[NT];
  float msq[NT];
  int flag[NT];  // 1 valid, 0 invalid (-inf), -1 past the split end
};

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Compare-exchange with the same register of lane ^ m: this lane keeps the
// better of the two entries if keep_better, else the worse.
__device__ __forceinline__ void cx_lanes(float& v, int& i, int m,
                                         bool keep_better) {
  const float pv = __shfl_xor_sync(FULL, v, m);
  const int pi = __shfl_xor_sync(FULL, i, m);
  if (better(pv, pi, v, i) == keep_better) { v = pv; i = pi; }
}

// Compare-exchange of the lane's own two entries (2*lane, 2*lane+1): the
// better one first if desc, else last.
__device__ __forceinline__ void cx_pair(float& v0, int& i0, float& v1,
                                        int& i1, bool desc) {
  if (better(v1, i1, v0, i0) == desc) {
    const float tv = v0; const int ti = i0;
    v0 = v1; i0 = i1; v1 = tv; i1 = ti;
  }
}

// Bitonic sort of 64 entries, best first; entry j = 2*lane + h is register
// h of lane `lane`, so the distance-1 steps stay inside a lane.
__device__ __forceinline__ void sort64(float& v0, int& i0, float& v1, int& i1,
                                       int lane) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
    const bool desc = ((2 * lane) & size) == 0;
#pragma unroll
    for (int d = size / 2; d >= 2; d >>= 1) {
      const bool keep_better = (((2 * lane) & d) == 0) == desc;
      cx_lanes(v0, i0, d / 2, keep_better);
      cx_lanes(v1, i1, d / 2, keep_better);
    }
    cx_pair(v0, i0, v1, i1, desc);
  }
}

// (v, i) and (cv, ci): two lists of 64 entries, each sorted best first, laid
// out as in sort64. Leaves the best 64 of their union, sorted, in (v, i).
__device__ __forceinline__ void merge64(float& v0, int& i0, float& v1,
                                        int& i1, float cv0, int ci0,
                                        float cv1, int ci1, int lane) {
  // c[63 - j] for j = 2*lane + h is register 1 - h of lane 31 - lane
  const float rv0 = __shfl_xor_sync(FULL, cv1, 31);
  const int ri0 = __shfl_xor_sync(FULL, ci1, 31);
  const float rv1 = __shfl_xor_sync(FULL, cv0, 31);
  const int ri1 = __shfl_xor_sync(FULL, ci0, 31);
  // the better of list[j] and c[63 - j] holds the best 64, as a bitonic
  // sequence (descending, then ascending)
  if (better(rv0, ri0, v0, i0)) { v0 = rv0; i0 = ri0; }
  if (better(rv1, ri1, v1, i1)) { v1 = rv1; i1 = ri1; }
#pragma unroll
  for (int d = 32; d >= 2; d >>= 1) {
    const bool lower = ((2 * lane) & d) == 0;
    cx_lanes(v0, i0, d / 2, lower);
    cx_lanes(v1, i1, d / 2, lower);
  }
  cx_pair(v0, i0, v1, i1, true);
}

// Merges the survivors (entries whose bit is set in s0/s1, 1..FEW of them)
// into the sorted list (lv, li) of one query: each entry moves to its rank
// in the union, and the ranks below k are written back.
__device__ __forceinline__ void rank_merge(float* lv, int* li, int k,
                                           float xv0, int xi0, bool s0,
                                           float xv1, int xi1, bool s1,
                                           unsigned m0, unsigned m1,
                                           int lane) {
  const int j0 = 2 * lane, j1 = j0 + 1;
  const float2 pv = *reinterpret_cast<const float2*>(&lv[j0]);
  const int2 pi = *reinterpret_cast<const int2*>(&li[j0]);
  int up0 = 0, up1 = 0;  // survivors better than list entries j0, j1
  int at0 = 0, at1 = 0;  // ranks of this lane's survivors in the union
  while (m0 | m1) {
    const bool h = m0 == 0;  // the same in every lane
    const int src = __ffs(h ? m1 : m0) - 1;
    if (h) m1 &= m1 - 1; else m0 &= m0 - 1;
    const float cv = __shfl_sync(FULL, h ? xv1 : xv0, src);
    const int ci = __shfl_sync(FULL, h ? xi1 : xi0, src);
    up0 += better(cv, ci, pv.x, pi.x);
    up1 += better(cv, ci, pv.y, pi.y);
    at0 += better(cv, ci, xv0, xi0);
    at1 += better(cv, ci, xv1, xi1);
    // list entries better than the survivor: a prefix of the list
    const int p = __popc(__ballot_sync(FULL, better(pv.x, pi.x, cv, ci))) +
                  __popc(__ballot_sync(FULL, better(pv.y, pi.y, cv, ci)));
    if (lane == src) {
      if (h) at1 += p; else at0 += p;
    }
  }
  __syncwarp();  // every lane has read the list
  if (up0 > 0 && j0 + up0 < k) { lv[j0 + up0] = pv.x; li[j0 + up0] = pi.x; }
  if (up1 > 0 && j1 + up1 < k) { lv[j1 + up1] = pv.y; li[j1 + up1] = pi.y; }
  if (s0 && at0 < k) { lv[at0] = xv0; li[at0] = xi0; }
  if (s1 && at1 < k) { lv[at1] = xv1; li[at1] = xi1; }
  __syncwarp();
}

template <bool HAS_QE, typename T>
__global__ void __launch_bounds__(THREADS, 2)
sim_topk_split_kernel(const float* __restrict__ qk,
                      const float* __restrict__ qe,
                      const T* __restrict__ mk,
                      const T* __restrict__ ms,
                      const uint8_t* __restrict__ valid,
                      int Q, int N, int ck, int k, int split_len,
                      float divisor, int2* __restrict__ cand) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  // this block's video: its own queries, ring and scratch
  const size_t b = blockIdx.z;
  qk += b * Q * ck;
  if (HAS_QE) qe += b * Q * ck;
  mk += b * N * ck;
  if (ms != nullptr) ms += b * N;
  if (valid != nullptr) valid += b * N;
  cand += b * gridDim.y * Q * k;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y;
  const int n_begin = split * split_len;
  const int n_end = min(N, n_begin + split_len);

  for (int x = tid; x < QT * CK_MAX; x += THREADS) {
    const int ql = x / CK_MAX, c = x % CK_MAX, q = q0 + ql;
    const bool in = q < Q && c < ck;
    const float qv = in ? qk[(size_t)q * ck + c] : 0.f;
    if (HAS_QE) {
      const float ev = in ? qe[(size_t)q * ck + c] : 0.f;
      s.a[c][ql] = __fmul_rn(qv, ev);
      s.e[c][ql] = ev;
      s.u.qk[c][ql] = qv;
    } else {
      s.a[c][ql] = qv;
    }
  }
  for (int x = tid; x < QT * K_MAX; x += THREADS) {
    s.list_v[x / K_MAX][x % K_MAX] = -INFINITY;
    s.list_i[x / K_MAX][x % K_MAX] = NO_INDEX;
  }
  __syncthreads();
  if (tid < QT) {
    // bsq = sum over c of (qe*qk)*qk, rounded product by product, in order
    float b = 0.f;
    if (HAS_QE)
      for (int c = 0; c < ck; ++c)
        b = __fadd_rn(b, __fmul_rn(s.a[c][tid], s.u.qk[c][tid]));
    s.bsq[tid] = b;
  }
  __syncthreads();  // the token tiles overwrite the query staging

  for (int t0 = n_begin; t0 < n_end; t0 += NT) {
    for (int x = tid; x < NT * CK_MAX; x += THREADS) {
      const int nl = x / CK_MAX, c = x % CK_MAX, n = t0 + nl;
      const float mv =
          (n < n_end && c < ck) ? widen(mk[(size_t)n * ck + c]) : 0.f;
      s.u.tile.m[c][nl] = mv;
      if (HAS_QE) s.u.tile.m2[c][nl] = __fmul_rn(mv, mv);
    }
    for (int x = tid; x < NT; x += THREADS) {
      const int n = t0 + x;
      const bool present = n < n_end;
      s.msv[x] =
          present ? __fdiv_rn(ms != nullptr ? widen(ms[n]) : 1.f, divisor)
                  : 0.f;
      s.flag[x] = !present ? -1 : ((valid == nullptr || valid[n]) ? 1 : 0);
    }
    __syncthreads();
    if (!HAS_QE && tid < NT) {
      // msq = sum over c of mk*mk, in order; read after the next barrier
      float m = 0.f;
      for (int c = 0; c < ck; ++c)
        m = __fadd_rn(m, __fmul_rn(s.u.tile.m[c][tid], s.u.tile.m[c][tid]));
      s.msq[tid] = m;
    }

    float ab[4][4], sq[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) { ab[i][j] = 0.f; sq[i][j] = 0.f; }
#pragma unroll 4
    for (int c = 0; c < ck; ++c) {
      const float4 a4 = *reinterpret_cast<const float4*>(&s.a[c][ty * 4]);
      const float4 b4 =
          *reinterpret_cast<const float4*>(&s.u.tile.m[c][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ab[i][j] = fmaf(av[i], bv[j], ab[i][j]);
      if (HAS_QE) {
        const float4 e4 = *reinterpret_cast<const float4*>(&s.e[c][ty * 4]);
        const float4 c4 =
            *reinterpret_cast<const float4*>(&s.u.tile.m2[c][tx * 4]);
        const float ev[4] = {e4.x, e4.y, e4.z, e4.w};
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sq[i][j] = fmaf(ev[i], cv[j], sq[i][j]);
      }
    }
    __syncthreads();  // the similarity tile overwrites the token tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ql = ty * 4 + i;
      float out[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nl = tx * 4 + j;
        const float a_sq = HAS_QE ? sq[i][j] : s.msq[nl];
        float sim = (2.f * ab[i][j] - a_sq - s.bsq[ql]) * s.msv[nl];
        if (s.flag[nl] == 0) sim = -INFINITY;
        out[j] = sim;
      }
      *reinterpret_cast<float4*>(&s.u.sim[ql][tx * 4]) =
          make_float4(out[0], out[1], out[2], out[3]);
    }
    __syncthreads();

    // selection: warp w keeps the lists of queries w*8 .. w*8+7
    const int2 fl = *reinterpret_cast<const int2*>(&s.flag[2 * lane]);
    const int xi0 = t0 + 2 * lane, xi1 = xi0 + 1;
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int ql = warp * ROWS_PER_WARP + r;
      if (q0 + ql >= Q) break;
      float* lv = s.list_v[ql];
      int* li = s.list_i[ql];
      const float2 x =
          *reinterpret_cast<const float2*>(&s.u.sim[ql][2 * lane]);
      const float tv = lv[k - 1];
      const int ti = li[k - 1];
      const bool s0 = fl.x >= 0 && better(x.x, xi0, tv, ti);
      const bool s1 = fl.y >= 0 && better(x.y, xi1, tv, ti);
      const unsigned m0 = __ballot_sync(FULL, s0);
      const unsigned m1 = __ballot_sync(FULL, s1);
      const int survivors = __popc(m0) + __popc(m1);
      if (survivors == 0) continue;
      if (survivors <= FEW) {
        rank_merge(lv, li, k, x.x, xi0, s0, x.y, xi1, s1, m0, m1, lane);
        continue;
      }
      float v0 = s0 ? x.x : -INFINITY, v1 = s1 ? x.y : -INFINITY;
      int i0 = s0 ? xi0 : NO_INDEX, i1 = s1 ? xi1 : NO_INDEX;
      sort64(v0, i0, v1, i1, lane);
      const float2 pv = *reinterpret_cast<const float2*>(&lv[2 * lane]);
      const int2 pi = *reinterpret_cast<const int2*>(&li[2 * lane]);
      float w0 = pv.x, w1 = pv.y;
      int wi0 = pi.x, wi1 = pi.y;
      merge64(w0, wi0, w1, wi1, v0, i0, v1, i1, lane);
      __syncwarp();  // every lane has read the list
      if (2 * lane < k) { lv[2 * lane] = w0; li[2 * lane] = wi0; }
      if (2 * lane + 1 < k) { lv[2 * lane + 1] = w1; li[2 * lane + 1] = wi1; }
      __syncwarp();
    }
    __syncthreads();
  }

  for (int x = tid; x < QT * k; x += THREADS) {
    const int ql = x / k, r = x % k, q = q0 + ql;
    if (q < Q)
      cand[((size_t)split * Q + q) * k + r] =
          make_int2(__float_as_int(s.list_v[ql][r]), s.list_i[ql][r]);
  }
}

// One list of k (value bits, index) pairs, sentinels past k, laid out as in
// sort64.
__device__ __forceinline__ void load_list(const int2* __restrict__ row, int k,
                                          int lane, float& v0, int& i0,
                                          float& v1, int& i1) {
  const int2 none = make_int2(__float_as_int(-INFINITY), NO_INDEX);
  const int2 a = 2 * lane < k ? row[2 * lane] : none;
  const int2 b = 2 * lane + 1 < k ? row[2 * lane + 1] : none;
  v0 = __int_as_float(a.x); i0 = a.y;
  v1 = __int_as_float(b.x); i1 = b.y;
}

// Merges the per-split sorted lists of each query into its global top-k:
// one warp per query, split after split, with merge64.
__global__ void __launch_bounds__(MERGE_WARPS * 32)
sim_topk_merge_kernel(const int2* __restrict__ cand, int splits, int Q,
                      int k, float* __restrict__ out_v,
                      int* __restrict__ out_i) {
  const int lane = threadIdx.x % 32;
  const int q = blockIdx.x * MERGE_WARPS + threadIdx.x / 32;
  if (q >= Q) return;  // the whole warp
  const size_t b = blockIdx.y;  // the video
  cand += b * splits * Q * k;
  out_v += b * Q * k;
  out_i += b * Q * k;
  float v0, v1;
  int i0, i1;
  load_list(cand + (size_t)q * k, k, lane, v0, i0, v1, i1);
  for (int sp = 1; sp < splits; ++sp) {
    float c0, c1;
    int d0, d1;
    load_list(cand + ((size_t)sp * Q + q) * k, k, lane, c0, d0, c1, d1);
    merge64(v0, i0, v1, i1, c0, d0, c1, d1, lane);
  }
  if (2 * lane < k) {
    out_v[(size_t)q * k + 2 * lane] = v0;
    out_i[(size_t)q * k + 2 * lane] = i0;
  }
  if (2 * lane + 1 < k) {
    out_v[(size_t)q * k + 2 * lane + 1] = v1;
    out_i[(size_t)q * k + 2 * lane + 1] = i1;
  }
}

// The selection kernel's dynamic shared memory exceeds the 48 KB default:
// raise its limit once per template instance and device.
template <bool HAS_QE, typename T>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev % 64);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(sim_topk_split_kernel<HAS_QE, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(Smem));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <bool HAS_QE, typename T>
cudaError_t launch_split(dim3 grid, cudaStream_t st, const float* qk,
                         const float* qe, const void* mk, const void* ms,
                         const uint8_t* valid, int Q, int N, int ck, int k,
                         int split_len, float divisor, int2* cand) {
  const cudaError_t err = allow_smem<HAS_QE, T>();
  if (err != cudaSuccess) return err;
  sim_topk_split_kernel<HAS_QE, T><<<grid, THREADS, sizeof(Smem), st>>>(
      qk, qe, static_cast<const T*>(mk), static_cast<const T*>(ms), valid, Q,
      N, ck, k, split_len, divisor, cand);
  return cudaGetLastError();
}

}  // namespace

// B videos: qk, qe [B, Q, ck]; mk [B, N, ck]; ms, valid [B, N]; out_v,
// out_i [B, Q, k] (B = 1: one video). qe, ms and valid may be null. mk and
// ms are float (ring_bf16 = 0) or bf16 (1). The token axis is cut into
// `splits` splits of split_len tokens (a multiple of NT). scratch holds
// [B, splits, Q, k] (value bits, index) pairs. Returns the CUDA error code
// of the two launches.
extern "C" int deva_sim_topk(const float* qk, const float* qe,
                             const void* mk, const void* ms,
                             const uint8_t* valid, int ring_bf16, int B,
                             int Q, int N, int ck, int k, int splits,
                             int split_len, float divisor, int* scratch,
                             float* out_v, int* out_i, void* stream) {
  if ((ring_bf16 != 0 && ring_bf16 != 1) || B <= 0 || B > 65535 || Q <= 0 ||
      N <= 0 || ck <= 0 ||
      ck > CK_MAX || k <= 0 || k > K_MAX ||
      k > N || splits <= 0 || splits > MAX_SPLITS || split_len <= 0 ||
      split_len % NT != 0 || (long long)splits * split_len < N ||
      (long long)(splits - 1) * split_len >= N || !(divisor > 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int2* cand = reinterpret_cast<int2*>(scratch);
  const dim3 grid((Q + QT - 1) / QT, splits, B);
  auto go = qe != nullptr
                ? (ring_bf16 ? launch_split<true, bf16>
                             : launch_split<true, float>)
                : (ring_bf16 ? launch_split<false, bf16>
                             : launch_split<false, float>);
  cudaError_t err = go(grid, st, qk, qe, mk, ms, valid, Q, N, ck, k,
                       split_len, divisor, cand);
  if (err != cudaSuccess) return (int)err;
  const dim3 merge_grid((Q + MERGE_WARPS - 1) / MERGE_WARPS, B);
  sim_topk_merge_kernel<<<merge_grid, MERGE_WARPS * 32, 0, st>>>(
      cand, splits, Q, k, out_v, out_i);
  return (int)cudaGetLastError();
}
