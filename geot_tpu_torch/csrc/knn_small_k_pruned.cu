// Exact fused kNN for k <= 4 on xyz with Morton-chunk pruning:
// (B, Q, 3), (B, N, 3) f32 -> squared d2 and i32 idx, each (B, Q, k).
//
// Replaces the Pallas TPU kernel
// geot_tpu/ops/pallas_knn_pruned.py:knn_small_k_pruned (_kernel). Contract:
// that of knn_small_k.cu, bit for bit: for every query the k supports
// smallest in (d2, original index) order, ascending; ties go to the smaller
// index; a query that is also a support finds itself at d2 = 0.
//
// Input, prepared by the wrapper (geot_tpu_torch/ops/knn.py:
// knn_small_k_pruned) in plain PyTorch: queries and supports each sorted by
// Morton code, the original index of every sorted support, and per query
// tile of 256 sorted queries the chunks of 1024 sorted supports in
// near-first order with their box-to-box squared distances. The kernel
// writes rows in sorted query order; the wrapper scatters them back to the
// caller's order.
//
// Design: one block of 256 threads per (cloud, query tile), one thread per
// query, its k best as a sorted (d2, original index) list in registers.
// Query slots past Q repeat the last sorted query (they keep the tile's
// bound real and write nothing). For each chunk in visit order the block
// tests d2cb * 0.99999 <= worst, where worst is the block-wide largest
// k-th best so far (+inf until the list is full): a chunk that fails holds
// no support nearer than any query's k-th best and is skipped whole. The
// test reads the same values in every thread, so the branch is uniform. A
// chunk that passes is staged through shared memory (structure of arrays,
// broadcast reads) and scanned. Supports arrive in Morton order, not index
// order, so a candidate enters when (d2, index) is lexicographically
// smaller than the k-th entry, and the bubble compares (d2, index) too.
//
// Arithmetic: d2 = dx*dx + dy*dy + dz*dz with separate roundings (the
// library is built with --fmad=false), as knn_small_k.cu and the plain
// version.
//
// What bounds it: 8 fp32 operations per (query, support) pair that is not
// pruned. The pairs pruned away depend on the data; the block-wide bound
// is as loose as the tile's worst query.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;               // queries per tile
constexpr int kChunk = 1024;                // supports per chunk
constexpr unsigned kFull = 0xffffffffu;

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_pruned_kernel(const float* __restrict__ q_all,
                  const float* __restrict__ s_all,
                  const int* __restrict__ sidx_all,
                  const int* __restrict__ visit_all,
                  const float* __restrict__ d2cb_all,
                  float* __restrict__ d_all,
                  int* __restrict__ i_all, unsigned long long* skipped, int Q,
                  int N, int NT, int NC) {
  __shared__ float sx[kChunk], sy[kChunk], sz[kChunk];
  __shared__ int si[kChunk];
  __shared__ float s_wmax[kThreads / 32];

  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int p = tile * kThreads + threadIdx.x;
  const int pq = p < Q ? p : Q - 1;
  const float* qp = q_all + ((size_t)b * Q + pq) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float* sp = s_all + (size_t)b * N * 3;
  const int* sidx = sidx_all + (size_t)b * N;
  const int* visit = visit_all + ((size_t)b * NT + tile) * NC;
  const float* d2cb = d2cb_all + ((size_t)b * NT + tile) * NC;

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = __int_as_float(0x7f800000);  // +inf
    bi[s] = 1 << 30;
  }
  float worst = __int_as_float(0x7f800000);
  unsigned long long n_skip = 0;

  for (int ci = 0; ci < NC; ++ci) {
    if (!(d2cb[ci] * 0.99999f <= worst)) {
      ++n_skip;
      continue;
    }
    const int c = visit[ci];
    const int base = c * kChunk;
    const int n = N - base < kChunk ? N - base : kChunk;
    __syncthreads();  // the previous chunk is no longer read
    for (int j = threadIdx.x; j < n; j += kThreads) {
      sx[j] = sp[3 * (base + j)];
      sy[j] = sp[3 * (base + j) + 1];
      sz[j] = sp[3 * (base + j) + 2];
      si[j] = sidx[base + j];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float dx = qx - sx[j], dy = qy - sy[j], dz = qz - sz[j];
      const float d = dx * dx + dy * dy + dz * dz;
      const int id = si[j];
      if (d < bd[K - 1] || (d == bd[K - 1] && id < bi[K - 1])) {
        float cd = d;
        int ci2 = id;
#pragma unroll
        for (int s = 0; s < K; ++s) {
          if (cd < bd[s] || (cd == bd[s] && ci2 < bi[s])) {
            const float td = bd[s];
            const int ti = bi[s];
            bd[s] = cd;
            bi[s] = ci2;
            cd = td;
            ci2 = ti;
          }
        }
      }
    }
    // worst = the block's largest k-th best (d2 >= 0, so the float bits
    // order like the values; +inf too)
    const unsigned wmax =
        __reduce_max_sync(kFull, __float_as_uint(bd[K - 1]));
    if ((threadIdx.x & 31) == 0)
      s_wmax[threadIdx.x >> 5] = __uint_as_float(wmax);
    __syncthreads();
    worst = s_wmax[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) worst = fmaxf(worst, s_wmax[w]);
  }
  if (skipped != nullptr && threadIdx.x == 0 && n_skip > 0)
    atomicAdd(skipped, n_skip);
  if (p >= Q) return;
  float* dp = d_all + ((size_t)b * Q + p) * K;
  int* ip = i_all + ((size_t)b * Q + p) * K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    dp[s] = bd[s];
    ip[s] = bi[s];
  }
}

template <int K>
int launch(const float* q, const float* s, const int* sidx, const int* visit,
           const float* d2cb, float* d, int* i, unsigned long long* skipped,
           int B, int Q, int N, int NT, int NC, cudaStream_t stream) {
  const dim3 grid(NT, B);
  knn_pruned_kernel<K><<<grid, kThreads, 0, stream>>>(
      q, s, sidx, visit, d2cb, d, i, skipped, Q, N, NT, NC);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// query: (B, Q, 3) sorted; support: (B, N, 3) sorted; sidx: (B, N) original
// index of each sorted support; visit, d2cb: (B, NT, NC) chunk visit order
// and the matching box-to-box squared distances, NT = ceil(Q / 256),
// NC = ceil(N / 1024); d2, idx: (B, Q, k) in sorted query order; skipped:
// one counter that gets the number of (tile, chunk) pairs skipped, or null.
// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// k outside 1..4.
extern "C" int geot_knn_small_k_pruned(const float* query,
                                       const float* support, const int* sidx,
                                       const int* visit, const float* d2cb,
                                       float* d2, int* idx,
                                       unsigned long long* skipped, int B,
                                       int Q, int N, int k, void* stream) {
  if (B <= 0 || Q <= 0) return 0;
  const int NT = (Q + kThreads - 1) / kThreads;
  const int NC = (N + kChunk - 1) / kChunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(query, support, sidx, visit, d2cb, d2, idx,
                             skipped, B, Q, N, NT, NC, st);
    case 2: return launch<2>(query, support, sidx, visit, d2cb, d2, idx,
                             skipped, B, Q, N, NT, NC, st);
    case 3: return launch<3>(query, support, sidx, visit, d2cb, d2, idx,
                             skipped, B, Q, N, NT, NC, st);
    case 4: return launch<4>(query, support, sidx, visit, d2cb, d2, idx,
                             skipped, B, Q, N, NT, NC, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
