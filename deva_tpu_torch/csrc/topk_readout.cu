// Sparse top-k readout: out[q, :] = sum_r w[q, r] * V[idx[q, r], :].
//
// Replaces the Pallas kernel `_readout_kernel`
// (deva_tpu/ops/pallas_attention.py:249-305, reached by `topk_readout`).
// The Pallas kernel rebuilds a dense [Q_T, N_T] affinity tile from the
// (idx, w) pairs and multiplies it against the value ring on the MXU: 2*Q*N*C
// multiply-adds, most of them by zero. Here the k value rows of each query
// are gathered directly: Q*k*C multiply-adds.
//
// What bounds it on the H100: bytes. At the 480p serving shape (Q=1620,
// k=30, C=2*512, N=512+16200) the queries need only ~1500 distinct value
// rows (6 MB), but gathered query by query they are Q*k*C*4 = 199 MB of L2
// reads. Neighbouring queries are neighbouring pixels and pick largely the
// same rows, so the design reads each row once per tile of queries:
//
// 1. One block per (tile of QT consecutive queries, slice of CS columns).
//    It loads the tile's QT*k (index, weight) pairs and deduplicates the
//    indices in a shared hash table (linear probing with atomicCAS); the
//    pair that inserts a row claims the row's slot (one atomicAdd per
//    warp). The block then copies the claimed row segments into shared
//    memory with cp.async (16 bytes a thread on the vector path), so the
//    tile reads U distinct rows instead of QT*k. Slots past CAP are not
//    staged: their pairs read the row from global memory, so a tile of
//    all-distinct rows is still right.
// 2. Every pair then holds a pointer to its row segment (the staged copy,
//    the global row, or a zero row for an index outside the ring, with
//    weight 0) and its weight, so the readout loop has no branch and can
//    keep many loads in flight.
// 3. Each thread owns (query, V neighbouring columns) items, two at once
//    on the vector path, and accumulates fmaf over r = 0..k-1 in order,
//    keeping the loads of both in flight: the result is bitwise that of a
//    query-per-block gather. Which rows are staged depends on the order in
//    which the threads claim them, the result does not.
//
// The ring may come in two segments, read in place (the long-term and the
// working ring): row i is V_a[i] for i < n_a, else V_b[i - n_a]. Indices
// outside [0, n_a + n_b) contribute nothing; an index repeated in a query's
// list counts each time.
//
// A video axis (the batched propagator's B videos): the grid's z dimension
// is the video. Video b's pairs start at idx/w + b*Q*k, its segments at
// V_a + b*n_a*C and V_b + b*n_b*C, its output at out + b*Q*C; indices are
// local to their video, and the dedup table and the staging belong to one
// 16-query tile of one video. So each video's result is bitwise that of
// its own launch. The per-video bases keep the 16-byte alignment of the
// vector path whenever C is a whole number of 16-byte vectors.
//
// The ring's elements are float or bf16 (ring.cuh), one template instance
// each. On bf16 rings a row segment takes half the bytes, staged and read
// as bf16 (the 16-byte path carries 8 elements, so it needs C % 8 == 0),
// each weight is rounded to bf16 once, with its pair, and each element is
// widened in the loop. The product of two bf16 numbers is exact in f32 and
// the sum runs in the same r order, so the result is bitwise the f32
// kernel's on (w rounded to bf16, V widened). The tile constants below are
// in elements, the same for both types.
//
// On the H100 this design is slower than the query-per-block gather it
// replaced (PERF.md): a block spends about as long on its pairs and its
// dedup as the gather spends on its rows, and with CAP = 64 (four blocks
// per SM, the fastest of the tiles swept) most rows of a tile still come
// from L2. Staging every row (two 200-row buffers of 64 columns, the dedup
// paid once per 8 slices) was slower still: the shared-memory reads of
// every (query, r) row segment move as many bytes as the gather moved from
// L2, at not much more than L2's rate, and the staging of a slice waits on
// its own round trip.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "ring.cuh"

namespace {

using deva_ring::bf16;

constexpr int QT = 16;   // queries per block
constexpr int CS = 128;  // value columns per block (floats)
constexpr int CAP = 64;  // distinct row segments staged in shared memory
constexpr int K_MAX = 64;
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 4;  // resident blocks per SM (64 registers)
constexpr int PPT = (QT * K_MAX + THREADS - 1) / THREADS;  // pairs a thread
constexpr int EMPTY = -1;
constexpr unsigned FULL = 0xffffffffu;

static_assert(CS % 8 == 0, "a slice holds whole 16-byte vectors");

// Hash table entries for `pairs` pairs: a power of two of at least twice
// as many, so linear probing stays short.
int table_bits(int pairs) {
  int bits = 1;
  while ((1 << bits) < 2 * pairs) ++bits;
  return bits;
}

// Dynamic shared memory of a block: the staged rows; each pair's row
// pointer and weight; the row of each slot; the table's keys and slots.
template <typename T>
size_t smem_bytes(int k) {
  const int pairs = QT * k;
  return (size_t)CAP * CS * sizeof(T) + (size_t)pairs * 16 +
         ((size_t)8 << table_bits(pairs));
}

// MIN_BLOCKS blocks fit an SM of the H100 (228 KB) at k <= 32 (the serving
// k is 30), with the static shared memory and the 1 KB reserved per block
// (counted for float rows, the larger)
static_assert(MIN_BLOCKS * ((size_t)CAP * CS * 4 + QT * 32 * 16 +
                            8 * 2 * QT * 32 + CS * 4 + 4 + 1024) <= 233472,
              "MIN_BLOCKS blocks fit an SM at k = 32");

template <typename T>
__device__ __forceinline__ const T* row_ptr(const T* va, int n_a,
                                            const T* vb, int C, int i) {
  return i < n_a ? va + (size_t)i * C : vb + (size_t)(i - n_a) * C;
}

// V elements of a row segment, global -> shared, asynchronously (.ca, the
// form that also takes the scalar path's 4-byte copies); cp.async moves no
// fewer than 4 bytes, so a single bf16 is copied by a plain load and store.
template <typename T, int V>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  if constexpr (V * sizeof(T) >= 4) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(V * (int)sizeof(T)));
  } else {
    *dst = *src;
  }
}

// A thread's accumulators for V neighbouring columns, f32; fma() adds w
// times the V elements of T at p (shared or global memory).
template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 4> {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  __device__ __forceinline__ void fma(float w, const float* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a.x = fmaf(w, v.x, a.x);
    a.y = fmaf(w, v.y, a.y);
    a.z = fmaf(w, v.z, a.z);
    a.w = fmaf(w, v.w, a.w);
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = a;
  }
};

template <>
struct Vec<float, 1> {
  float a = 0.f;
  __device__ __forceinline__ void fma(float w, const float* p) {
    a = fmaf(w, *p, a);
  }
  __device__ __forceinline__ void store(float* p) const { *p = a; }
};

template <>
struct Vec<bf16, 8> {
  float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  __device__ __forceinline__ void fma(float w, const bf16* p) {
    float v[8];
    deva_ring::load16(p, v);
#pragma unroll
    for (int x = 0; x < 8; ++x) a[x] = fmaf(w, v[x], a[x]);
  }
  __device__ __forceinline__ void store(float* p) const {
    reinterpret_cast<float4*>(p)[0] = make_float4(a[0], a[1], a[2], a[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(a[4], a[5], a[6], a[7]);
  }
};

template <>
struct Vec<bf16, 1> {
  float a = 0.f;
  __device__ __forceinline__ void fma(float w, const bf16* p) {
    a = fmaf(w, deva_ring::widen(*p), a);
  }
  __device__ __forceinline__ void store(float* p) const { *p = a; }
};

template <typename T, int V>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
topk_readout_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                    const T* __restrict__ va, int n_a,
                    const T* __restrict__ vb, int n_b, int Q, int k,
                    int C, int bits, float* __restrict__ out) {
  constexpr int SV = CS / V;                             // vectors a segment
  constexpr int ITEMS = (QT * SV + THREADS - 1) / THREADS;  // a thread's
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) T s_zero[CS];  // the row of absent indices
  __shared__ int s_used;                  // slots claimed
  const int table = 1 << bits;
  T* s_v = reinterpret_cast<T*>(smem);                            // [CAP][CS]
  const T** s_ptr = reinterpret_cast<const T**>(s_v + CAP * CS);
  float* s_wt = reinterpret_cast<float*>(s_ptr + QT * k);         // [QT*k]
  int* s_rows = reinterpret_cast<int*>(s_wt + QT * k);            // [QT*k]
  int* h_key = s_rows + QT * k;                                   // [table]
  int* h_slot = h_key + table;                                    // [table]

  // this block's video
  const size_t b = blockIdx.z;
  idx += b * Q * k;
  w += b * Q * k;
  if (va != nullptr) va += b * n_a * C;
  if (vb != nullptr) vb += b * n_b * C;
  out += b * Q * C;

  const int tid = threadIdx.x, lane = tid % 32;
  const int q0 = blockIdx.x * QT;
  const int qn = min(QT, Q - q0);
  const int pairs = qn * k;  // pair p = ql * k + r, contiguous in idx and w
  const int N = n_a + n_b;
  const int col0 = blockIdx.y * CS;
  const int units = min(CS, C - col0) / V;  // vectors of this slice

  // the tile's pairs (p = j * THREADS + tid), an empty table
  int row[PPT], pos[PPT];
  float wt[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = j * THREADS + tid;
    row[j] = EMPTY;
    wt[j] = 0.f;
    if (p < pairs) {
      const int i = idx[(size_t)q0 * k + p];
      if (i >= 0 && i < N) {
        row[j] = i;
        wt[j] = w[(size_t)q0 * k + p];
      }
    }
  }
  for (int t = tid; t < table; t += THREADS) h_key[t] = EMPTY;
  for (int c = tid; c < CS; c += THREADS) s_zero[c] = T(0.f);
  if (tid == 0) s_used = 0;
  __syncthreads();

  // insert every row; the pair that inserts it claims the next slot (one
  // atomicAdd per warp)
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    bool won = false;
    if (row[j] != EMPTY) {
      unsigned h = ((unsigned)row[j] * 2654435761u) >> (32 - bits);
      while (true) {
        const int prev = atomicCAS(&h_key[h], EMPTY, row[j]);
        if (prev == EMPTY || prev == row[j]) {
          won = prev == EMPTY;
          break;
        }
        h = (h + 1) & (table - 1);
      }
      pos[j] = (int)h;
    }
    const unsigned m = __ballot_sync(FULL, won);
    if (won) {
      const int leader = __ffs(m) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(&s_used, __popc(m));
      const int slot = __shfl_sync(m, base, leader) +
                       __popc(m & ((1u << lane) - 1));
      h_slot[pos[j]] = slot;
      s_rows[slot] = row[j];
    }
  }
  __syncthreads();

  // stage the first CAP claimed row segments; each pair's row segment and
  // weight
  const int staged = min(s_used, CAP);
  for (int f = tid; f < staged * SV; f += THREADS) {
    const int u = f / SV, c = f % SV;
    if (c < units)
      cp_async<T, V>(s_v + u * CS + c * V,
                     row_ptr(va, n_a, vb, C, s_rows[u]) + col0 + c * V);
  }
  asm volatile("cp.async.commit_group;\n" ::);
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = j * THREADS + tid;
    if (p >= pairs) continue;
    const T* src = s_zero;
    if (row[j] != EMPTY) {
      const int slot = h_slot[pos[j]];
      src = slot < CAP ? s_v + slot * CS
                       : row_ptr(va, n_a, vb, C, row[j]) + col0;
    }
    s_ptr[p] = src;
    s_wt[p] = deva_ring::weight<T>(wt[j]);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // the readout: fmaf over r in order, for the thread's items (query,
  // vector) at once; an item past the tile or the slice reads the first
  // query's rows and stores nothing
  const T* const* pp[ITEMS];
  const float* pw[ITEMS];
  int off[ITEMS];
  bool ok[ITEMS];
  Vec<T, V> acc[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int it = tid + i * THREADS, ql = it / SV, c = it % SV;
    ok[i] = ql < qn && c < units;
    pp[i] = s_ptr + (ok[i] ? ql : 0) * k;
    pw[i] = s_wt + (ok[i] ? ql : 0) * k;
    off[i] = ok[i] ? c * V : 0;
  }
#pragma unroll 2
  for (int r = 0; r < k; ++r)
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) acc[i].fma(pw[i][r], pp[i][r] + off[i]);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (!ok[i]) continue;
    const int it = tid + i * THREADS, ql = it / SV, c = it % SV;
    acc[i].store(out + (size_t)(q0 + ql) * C + col0 + c * V);
  }
}

// The dynamic shared memory exceeds the 48 KB default: raise the limit of
// each template instance once per device, to what k = K_MAX needs.
template <typename T, int V>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev % 64);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(topk_readout_kernel<T, V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<T>(K_MAX));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, int V>
cudaError_t launch(cudaStream_t st, const int* idx, const float* w,
                   const void* va, int n_a, const void* vb, int n_b, int B,
                   int Q, int k, int C, float* out) {
  const cudaError_t err = allow_smem<T, V>();
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + QT - 1) / QT, (C + CS - 1) / CS, B);
  topk_readout_kernel<T, V><<<grid, THREADS, smem_bytes<T>(k), st>>>(
      idx, w, static_cast<const T*>(va), n_a, static_cast<const T*>(vb),
      n_b, Q, k, C, table_bits(QT * k), out);
  return cudaGetLastError();
}

}  // namespace

// B videos: idx/w [B, Q, k]; the ring: va [B, n_a, C] then vb [B, n_b, C]
// (either may be empty; va or vb may be null when its length is 0), float
// (ring_bf16 = 0) or bf16 (1); out: [B, Q, C] (B = 1: one video). vec
// selects the 16-byte path: it requires C % 4 == 0 (float) or C % 8 == 0
// (bf16) and 16-byte aligned va, vb and out. Returns the CUDA error code of
// the launch.
extern "C" int deva_topk_readout(const int* idx, const float* w,
                                 const void* va, int n_a, const void* vb,
                                 int n_b, int ring_bf16, int B, int Q, int k,
                                 int C, int vec, float* out, void* stream) {
  const int per16 = ring_bf16 ? 8 : 4;  // elements in 16 bytes
  if (B <= 0 || B > 65535 || Q <= 0 || n_a < 0 || n_b < 0 ||
      (long long)n_a + n_b <= 0 ||
      (long long)n_a + n_b > INT32_MAX || C <= 0 || k <= 0 || k > K_MAX ||
      (ring_bf16 != 0 && ring_bf16 != 1) || (vec && C % per16 != 0) ||
      (n_a > 0 && va == nullptr) || (n_b > 0 && vb == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ring_bf16)
    err = vec ? launch<bf16, 8>(st, idx, w, va, n_a, vb, n_b, B, Q, k, C,
                                out)
              : launch<bf16, 1>(st, idx, w, va, n_a, vb, n_b, B, Q, k, C,
                                out);
  else
    err = vec ? launch<float, 4>(st, idx, w, va, n_a, vb, n_b, B, Q, k, C,
                                 out)
              : launch<float, 1>(st, idx, w, va, n_a, vb, n_b, B, Q, k, C,
                                 out);
  return (int)err;
}
