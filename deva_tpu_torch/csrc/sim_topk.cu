// Exact masked top-k of the anisotropic-L2 memory similarity, without the
// dense [Q, N] similarity in device memory.
//
// Replaces the Pallas kernel `_sim_topk_kernel` and its XLA candidate merge
// (deva_tpu/ops/pallas_attention.py:177-242, reached by `sim_topk`).
//
//   sim[q, n] = (2 * (qk*qe)[q] . mk[n] - qe[q] . mk[n]^2 - bsq[q]) * msv[n]
//
// with msv = ms / sqrt(Ck) (divided on the host side, like the Pallas path)
// and -inf on invalid ring slots. Without a selection (qe == nullptr) the
// a^2 term is the precomputed row msq[n] = sum(mk[n]^2) and bsq is zero.
// The result per query is the k best (value, index) pairs, ordered by value
// descending and then index ascending: ties go to the lowest index, as with
// lax.top_k and a stable descending sort.
//
// What bounds it on the H100: the similarity is 2*Q*N*Ck FFMAs in true f32
// (no TF32, no tensor cores: near-tie rankings must not flip). At the 480p
// serving shape (Q=1620, N=16712, Ck=64) that is 3.5 G FFMA; the keys are
// 4.3 MB and stay in L2. So the kernel is bound by the f32 FFMA rate and by
// the shared-memory traffic of its register tiles, not by device memory.
//
// Design:
// - A block owns QT=64 queries and one contiguous split of the token axis,
//   which it streams through shared memory in NT=64-token tiles. 256 threads
//   each compute a 4x4 register tile of similarities per token tile.
// - Each query keeps a running top-k list (k <= 64) in shared memory. A warp
//   filters a tile row against the list's current worst entry with one
//   ballot, and inserts the few survivors with a warp-parallel shift.
// - Splitting the token axis gives the card enough blocks at Q=1620 (26
//   query tiles alone would leave most of the 132 SMs idle). A second small
//   kernel merges the per-split lists with the same (value, index) order, so
//   the result does not depend on the number of splits.
// - Invalid slots take part as -inf with their own index, so a row with
//   fewer valid tokens than k gets in-range indices for its -inf slots (the
//   lowest invalid ones), exactly as the plain sorted version does. Token
//   slots past the end of the ring never take part.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;        // queries per block
constexpr int NT = 64;        // tokens per shared-memory tile
constexpr int CK_MAX = 64;    // key channels
constexpr int K_MAX = 64;     // bound on k
constexpr int THREADS = 256;  // 16 x 16 threads, 4x4 similarities each
constexpr int MAX_SPLITS = 32;
// Rows of the channel-major token tiles are padded by 4 floats: a tile is
// stored transposed (consecutive threads write consecutive channels), and
// with unpadded 64-float rows all 32 stores of a warp hit one bank. Padded,
// they spread over 8 banks, and the float4 reads stay 16-byte aligned.
constexpr int PAD = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_INDEX = 0x7fffffff;

// 99 KB, so that two blocks fit on an SM (228 KB): the similarity tile
// shares its space with the token tile it is computed from.
struct Smem {
  float a[CK_MAX][QT];    // (qk * qe), channel-major
  float e[CK_MAX][QT];    // qe, channel-major
  union {
    struct {
      float m[CK_MAX][NT + PAD];   // mk tile, channel-major
      float m2[CK_MAX][NT + PAD];  // mk^2 tile
    } tile;
    float sim[QT][NT + 1];  // the tile's similarities (padded: no conflicts)
  } u;
  float list_v[QT][K_MAX];
  int list_i[QT][K_MAX];
  float bsq[QT];
  float msv[NT];
  float msq[NT];
  int flag[NT];           // 1 valid, 0 invalid (-inf), -1 past the split end
};

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Insert (v, i) into the sorted list of one query. Called by a whole warp
// with the same (v, i) in every lane.
__device__ __forceinline__ void warp_insert(float* lv, int* li, int k,
                                            float v, int i, int lane) {
  // the list may have changed since the caller's ballot
  if (!better(v, i, lv[k - 1], li[k - 1])) return;
  const int j0 = lane, j1 = lane + 32;
  const bool b0 = j0 < k && better(lv[j0], li[j0], v, i);
  const bool b1 = j1 < k && better(lv[j1], li[j1], v, i);
  // the entries better than (v, i) are a prefix of the sorted list
  const int p = __popc(__ballot_sync(FULL, b0)) + __popc(__ballot_sync(FULL, b1));
  const bool s0 = j0 >= p && j0 <= k - 2;
  const bool s1 = j1 >= p && j1 <= k - 2;
  float v0 = 0.f, v1 = 0.f;
  int i0 = 0, i1 = 0;
  if (s0) { v0 = lv[j0]; i0 = li[j0]; }
  if (s1) { v1 = lv[j1]; i1 = li[j1]; }
  __syncwarp();
  if (s0) { lv[j0 + 1] = v0; li[j0 + 1] = i0; }
  if (s1) { lv[j1 + 1] = v1; li[j1 + 1] = i1; }
  if (lane == 0) { lv[p] = v; li[p] = i; }
  __syncwarp();
}

template <bool HAS_QE>
__global__ void __launch_bounds__(THREADS)
sim_topk_split_kernel(const float* __restrict__ qkqe,
                      const float* __restrict__ qe,
                      const float* __restrict__ bsq,
                      const float* __restrict__ mk,
                      const float* __restrict__ msq,
                      const float* __restrict__ msv,
                      const uint8_t* __restrict__ valid,
                      int Q, int N, int ck, int k, int split_len,
                      float* __restrict__ cand_v, int* __restrict__ cand_i) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

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
    s.a[c][ql] = in ? qkqe[(size_t)q * ck + c] : 0.f;
    if (HAS_QE) s.e[c][ql] = in ? qe[(size_t)q * ck + c] : 0.f;
  }
  for (int x = tid; x < QT; x += THREADS)
    s.bsq[x] = (q0 + x < Q) ? bsq[q0 + x] : 0.f;
  for (int x = tid; x < QT * K_MAX; x += THREADS) {
    s.list_v[x / K_MAX][x % K_MAX] = -INFINITY;
    s.list_i[x / K_MAX][x % K_MAX] = NO_INDEX;
  }
  __syncthreads();

  for (int t0 = n_begin; t0 < n_end; t0 += NT) {
    for (int x = tid; x < NT * CK_MAX; x += THREADS) {
      const int nl = x / CK_MAX, c = x % CK_MAX, n = t0 + nl;
      const float mv = (n < n_end && c < ck) ? mk[(size_t)n * ck + c] : 0.f;
      s.u.tile.m[c][nl] = mv;
      if (HAS_QE) s.u.tile.m2[c][nl] = mv * mv;
    }
    for (int x = tid; x < NT; x += THREADS) {
      const int n = t0 + x;
      const bool present = n < n_end;
      s.msv[x] = present ? msv[n] : 0.f;
      if (!HAS_QE) s.msq[x] = present ? msq[n] : 0.f;
      s.flag[x] = !present ? -1 : ((valid == nullptr || valid[n]) ? 1 : 0);
    }
    __syncthreads();

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
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = ty * 4 + i, nl = tx * 4 + j;
        const float a_sq = HAS_QE ? sq[i][j] : s.msq[nl];
        float sim = (2.f * ab[i][j] - a_sq - s.bsq[ql]) * s.msv[nl];
        if (s.flag[nl] == 0) sim = -INFINITY;
        s.u.sim[ql][nl] = sim;
      }
    __syncthreads();

    // selection: warp w keeps the lists of queries w*8 .. w*8+7
    for (int r = 0; r < QT / 8; ++r) {
      const int ql = warp * (QT / 8) + r;
      if (q0 + ql >= Q) break;
      float* lv = s.list_v[ql];
      int* li = s.list_i[ql];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int nl = lane + 32 * h;
        const float v = s.u.sim[ql][nl];
        const int idx = t0 + nl;
        unsigned pending = __ballot_sync(
            FULL, s.flag[nl] >= 0 && better(v, idx, lv[k - 1], li[k - 1]));
        while (pending) {
          const int src = __ffs(pending) - 1;
          pending &= pending - 1;
          const float cv = __shfl_sync(FULL, v, src);
          const int ci = __shfl_sync(FULL, idx, src);
          warp_insert(lv, li, k, cv, ci, lane);
        }
      }
    }
    __syncthreads();
  }

  for (int x = tid; x < QT * k; x += THREADS) {
    const int ql = x / k, r = x % k, q = q0 + ql;
    if (q < Q) {
      const size_t o = ((size_t)split * Q + q) * k + r;
      cand_v[o] = s.list_v[ql][r];
      cand_i[o] = s.list_i[ql][r];
    }
  }
}

// Merge the per-split sorted lists of each query into its global top-k.
__global__ void sim_topk_merge_kernel(const float* __restrict__ cand_v,
                                      const int* __restrict__ cand_i,
                                      int splits, int Q, int k,
                                      float* __restrict__ out_v,
                                      int* __restrict__ out_i) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  int head[MAX_SPLITS];
  for (int sp = 0; sp < splits; ++sp) head[sp] = 0;
  for (int r = 0; r < k; ++r) {
    int best = -1;
    float bv = -INFINITY;
    int bi = NO_INDEX;
    for (int sp = 0; sp < splits; ++sp) {
      if (head[sp] >= k) continue;
      const size_t o = ((size_t)sp * Q + q) * k + head[sp];
      const float v = cand_v[o];
      const int i = cand_i[o];
      if (best < 0 || better(v, i, bv, bi)) { best = sp; bv = v; bi = i; }
    }
    head[best] += 1;
    out_v[(size_t)q * k + r] = bv;
    out_i[(size_t)q * k + r] = bi;
  }
}

}  // namespace

extern "C" int deva_sim_topk_limits(int* qt, int* nt, int* ck_max,
                                    int* k_max, int* max_splits) {
  *qt = QT;
  *nt = NT;
  *ck_max = CK_MAX;
  *k_max = K_MAX;
  *max_splits = MAX_SPLITS;
  return 0;
}

// qe and valid may be null; msq is read only when qe is null. cand_v/cand_i
// hold [splits, Q, k] scratch. Returns the CUDA error code of the launches.
extern "C" int deva_sim_topk(const float* qkqe, const float* qe,
                             const float* bsq, const float* mk,
                             const float* msq, const float* msv,
                             const uint8_t* valid, int Q, int N, int ck,
                             int k, int splits, int split_len, float* cand_v,
                             int* cand_i, float* out_v, int* out_i,
                             void* stream) {
  if (Q <= 0 || N <= 0 || ck <= 0 || ck > CK_MAX || k <= 0 || k > K_MAX ||
      k > N || splits <= 0 || splits > MAX_SPLITS || split_len % NT != 0 ||
      (long long)splits * split_len < N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(Smem);
  const dim3 grid((Q + QT - 1) / QT, splits);
  cudaError_t err;
  if (qe != nullptr) {
    err = cudaFuncSetAttribute(sim_topk_split_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    sim_topk_split_kernel<true><<<grid, THREADS, smem, st>>>(
        qkqe, qe, bsq, mk, msq, msv, valid, Q, N, ck, k, split_len, cand_v,
        cand_i);
  } else {
    err = cudaFuncSetAttribute(sim_topk_split_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    sim_topk_split_kernel<false><<<grid, THREADS, smem, st>>>(
        qkqe, qe, bsq, mk, msq, msv, valid, Q, N, ck, k, split_len, cand_v,
        cand_i);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sim_topk_merge_kernel<<<(Q + 127) / 128, 128, 0, st>>>(cand_v, cand_i,
                                                         splits, Q, k, out_v,
                                                         out_i);
  return (int)cudaGetLastError();
}
