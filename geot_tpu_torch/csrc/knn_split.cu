// Exact fused kNN for k <= 4 on xyz, split over the support range:
// (B, Q, 3), (B, N, 3) f32 -> squared d2 (B, Q, k) f32, idx (B, Q, k) i32.
//
// Replaces the Pallas TPU kernel geot_tpu/ops/pallas_knn.py:knn_small_k_pallas
// (_knn_kernel), as csrc/knn_small_k.cu does, with the same contract bit for
// bit: for every query the k supports smallest in (d2, index) order,
// ascending; ties go to the smaller index; a query that is also a support
// finds itself at d2 = 0.
//
// What bounds it: 8 fp32 operations per (query, support) pair. knn_small_k.cu
// (one thread per query, 128 queries per block) leaves most of the 132 SMs
// idle when Q is a few thousand, and pays 3 shared-memory loads per pair.
//
// Design:
//   - each thread keeps one query and reads supports 4 at a time from
//     shared memory as three broadcast float4 (12 floats). A list fills
//     early in every split, when entries are frequent, and a warp runs the
//     insert whenever one of its queries needs it: on an H100 SXM at 700 W
//     one query per thread beat 2 and 4 in total time over the serving
//     path's searches, although more queries per thread reuse each read;
//   - the support range is cut into S contiguous splits over blockIdx.z
//     (the wrapper's plan picks S so the grid fills the card several
//     times); a block visits its split in ascending index order, so the
//     strict d < bd[k-1] early exit keeps ties to the smaller index;
//   - the insert is branch-free and runs only when the support enters the
//     list (the strict d < bd[k-1] test);
//   - the block stages its split in tiles of kTile supports with 4-byte
//     cp.async into two shared-memory buffers, so the next tile's copy runs
//     under the current tile's distance work (4-byte copies because the
//     (N, 3) rows are not 16-byte aligned in general);
//   - with S = 1 the block writes the result; otherwise each split writes
//     its sorted k-best to scratch (S, B, Q, k) that the wrapper allocates,
//     and a merge kernel takes per query the k smallest of the S lists in
//     (d2, index) order. Lexicographic k-selection decomposes over disjoint
//     index ranges, so the merge gives exactly the unsplit result.
//
// Arithmetic: d2 = dx*dx + dy*dy + dz*dz with separate roundings under
// --fmad=false, as knn_small_k.cu and the plain version knn_small_k_ref.
//
// Non-finite d2 (an inf or NaN coordinate): the plain version orders d2 by
// its bits, so +inf and then NaN come after every number, equal bits by
// index. The scan inserts finite d2 only; a list that it leaves short is
// completed from the split's non-finite d2 in that order by a second pass
// (fill_nonfinite), which runs only for such a query, and the merge ranks
// by the bits. Without it a NaN query would return the index N.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;               // one query per thread
constexpr int kTile = 1024;                 // supports per staged tile
constexpr int kMergeThreads = 256;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Insert (d, i) into the ascending list (bd, bi) of K entries when d is
// strictly smaller than an entry. Callers visit candidates in ascending
// index order (a split's supports; the splits' lists in split order), so a
// candidate's index is larger than that of every entry with an equal d2 and
// strict < is the (d2, index) order. Branch-free: c[s] = d < bd[s] is
// monotone in s, so slot s takes d, bd[s - 1] or stays, all from the old
// list; with c[K - 1] false nothing changes.
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d,
                                       int i) {
  bool c[K];
#pragma unroll
  for (int s = 0; s < K; ++s) c[s] = d < bd[s];
#pragma unroll
  for (int s = K - 1; s >= 1; --s) {
    bd[s] = c[s] ? (c[s - 1] ? bd[s - 1] : d) : bd[s];
    bi[s] = c[s] ? (c[s - 1] ? bi[s - 1] : i) : bi[s];
  }
  bd[0] = c[0] ? d : bd[0];
  bi[0] = c[0] ? i : bi[0];
}

// Insert (d, i) by (bits of d, index), for non-finite d2 and the merge: an
// empty slot (index N) takes any candidate; a non-negative float, +inf and
// a positive NaN order like their bits. Candidates come in ascending index
// order, so strict < keeps ties to the smaller index.
template <int K>
__device__ __forceinline__ void insert_bits(float (&bd)[K], int (&bi)[K],
                                            float d, int i, int N) {
  bool c[K];
#pragma unroll
  for (int s = 0; s < K; ++s)
    c[s] = bi[s] == N || __float_as_uint(d) < __float_as_uint(bd[s]);
#pragma unroll
  for (int s = K - 1; s >= 1; --s) {
    bd[s] = c[s] ? (c[s - 1] ? bd[s - 1] : d) : bd[s];
    bi[s] = c[s] ? (c[s - 1] ? bi[s - 1] : i) : bi[s];
  }
  bd[0] = c[0] ? d : bd[0];
  bi[0] = c[0] ? i : bi[0];
}

// After the scan of supports [lo, hi): a slot still empty means fewer than
// K of them had a finite d2 to the query; take the non-finite ones in
// (bits, index) order. Reads the supports again from global memory, and
// only for such a query.
template <int K>
__device__ void fill_nonfinite(float (&bd)[K], int (&bi)[K], float qx,
                               float qy, float qz, const float* sp, int lo,
                               int hi, int N) {
  if (bi[K - 1] != N) return;
  for (int j = lo; j < hi; ++j) {
    const float dx = qx - sp[3 * j], dy = qy - sp[3 * j + 1],
                dz = qz - sp[3 * j + 2];
    const float d = dx * dx + dy * dy + dz * dz;
    if (!(d < __int_as_float(0x7f800000))) insert_bits<K>(bd, bi, d, j, N);
  }
}

// one support against the thread's query
template <int K>
__device__ __forceinline__ void visit(float qx, float qy, float qz,
                                      float (&bd)[K], int (&bi)[K], float sx,
                                      float sy, float sz, int si) {
  const float dx = qx - sx, dy = qy - sy, dz = qz - sz;
  const float d = dx * dx + dy * dy + dz * dz;
  if (d < bd[K - 1]) insert<K>(bd, bi, d, si);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_split_kernel(const float* __restrict__ q_all,
                 const float* __restrict__ s_all, float* __restrict__ d_out,
                 int* __restrict__ i_out, int B, int Q, int N,
                 int split_len) {
  __shared__ __align__(16) float tile[2][3 * kTile];
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int s_lo = split * split_len;
  const int s_hi = min(N, s_lo + split_len);
  const float* sp = s_all + (size_t)b * N * 3;

  const float* qp = q_all + ((size_t)b * Q + min(q, Q - 1)) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = __int_as_float(0x7f800000);  // +inf
    bi[s] = N;
  }

  const int n_tiles = (s_hi - s_lo + kTile - 1) / kTile;
  auto stage = [&](int it) {
    const int base = s_lo + it * kTile;
    const int words = 3 * min(kTile, s_hi - base);
    float* dst = tile[it & 1];
    const float* src = sp + 3 * (size_t)base;
    for (int w = threadIdx.x; w < words; w += kThreads)
      cp_async4(dst + w, src + w);
  };
  if (n_tiles > 0) stage(0);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) stage(it + 1);
    cp_async_commit();       // possibly empty: the wait below stays uniform
    cp_async_wait_one();     // tile `it` has landed for this thread ...
    __syncthreads();         // ... and for every thread
    const float* buf = tile[it & 1];
    const int base = s_lo + it * kTile;
    const int n = min(kTile, s_hi - base);
    int j = 0;
    for (; j + 4 <= n; j += 4) {
      const float4* p = reinterpret_cast<const float4*>(buf + 3 * j);
      const float4 a = p[0], c = p[1], e = p[2];
      visit<K>(qx, qy, qz, bd, bi, a.x, a.y, a.z, base + j);
      visit<K>(qx, qy, qz, bd, bi, a.w, c.x, c.y, base + j + 1);
      visit<K>(qx, qy, qz, bd, bi, c.z, c.w, e.x, base + j + 2);
      visit<K>(qx, qy, qz, bd, bi, e.y, e.z, e.w, base + j + 3);
    }
    for (; j < n; ++j)
      visit<K>(qx, qy, qz, bd, bi, buf[3 * j], buf[3 * j + 1],
               buf[3 * j + 2], base + j);
    __syncthreads();         // the buffer is free for tile it + 2
  }

  // (split, b, q, k) layout; with one split that is the output itself
  if (q >= Q) return;
  fill_nonfinite<K>(bd, bi, qx, qy, qz, sp, s_lo, s_hi, N);
  const size_t o = ((size_t)split * B * Q + (size_t)b * Q + q) * K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    d_out[o + s] = bd[s];
    i_out[o + s] = bi[s];
  }
}

// per (b, q): the k smallest of the S sorted split lists, (d2, index)
template <int K>
__global__ void __launch_bounds__(kMergeThreads)
knn_merge_kernel(const float* __restrict__ sd, const int* __restrict__ si,
                 float* __restrict__ d_out, int* __restrict__ i_out, int BQ,
                 int S, int N) {
  const int row = blockIdx.x * kMergeThreads + threadIdx.x;
  if (row >= BQ) return;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = __int_as_float(0x7f800000);
    bi[s] = N;
  }
  for (int p = 0; p < S; ++p) {     // split order: ascending indices
    const size_t o = ((size_t)p * BQ + row) * K;
#pragma unroll
    for (int e = 0; e < K; ++e)
      if (si[o + e] != N) insert_bits<K>(bd, bi, sd[o + e], si[o + e], N);
  }
  const size_t o = (size_t)row * K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    d_out[o + s] = bd[s];
    i_out[o + s] = bi[s];
  }
}

template <int K>
int launch(const float* q, const float* s, float* d, int* i, float* sd,
           int* si, int B, int Q, int N, int S, int split_len,
           cudaStream_t stream) {
  const dim3 grid((Q + kThreads - 1) / kThreads, B, S);
  if (S == 1) {
    knn_split_kernel<K><<<grid, kThreads, 0, stream>>>(q, s, d, i, B, Q, N,
                                                       split_len);
    return static_cast<int>(cudaGetLastError());
  }
  knn_split_kernel<K><<<grid, kThreads, 0, stream>>>(q, s, sd, si, B, Q, N,
                                                     split_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int BQ = B * Q;
  knn_merge_kernel<K><<<(BQ + kMergeThreads - 1) / kMergeThreads,
                        kMergeThreads, 0, stream>>>(sd, si, d, i, BQ, S, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// S splits of split_len supports (S * split_len >= N, every split
// non-empty). With S > 1, sd / si are scratch of S * B * Q * k floats /
// ints (may be null when S == 1). Returns cudaGetLastError() after the
// launches; cudaErrorInvalidValue for a k outside 1..4 or a bad split.
extern "C" int geot_knn_split(const float* query, const float* support,
                              float* d2, int* idx, float* sd, int* si, int B,
                              int Q, int N, int k, int S, int split_len,
                              void* stream) {
  if (B <= 0 || Q <= 0) return 0;
  if (S < 1 || split_len < 1 || static_cast<long long>(S) * split_len < N
      || (S - 1) * split_len >= N || (S > 1 && (sd == nullptr || si == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(query, support, d2, idx, sd, si, B, Q, N, S,
                             split_len, st);
    case 2: return launch<2>(query, support, d2, idx, sd, si, B, Q, N, S,
                             split_len, st);
    case 3: return launch<3>(query, support, d2, idx, sd, si, B, Q, N, S,
                             split_len, st);
    case 4: return launch<4>(query, support, d2, idx, sd, si, B, Q, N, S,
                             split_len, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
