// Exact fused kNN for k <= 4 on xyz:
// (B, Q, 3), (B, N, 3) f32 -> squared d2 (B, Q, k) f32, idx (B, Q, k) i32.
//
// Replaces the Pallas TPU kernel geot_tpu/ops/pallas_knn.py:knn_small_k_pallas
// (_knn_kernel). Contract: for every query the k supports smallest in
// (d2, index) order, ascending; ties go to the smaller index (lax.top_k's
// rule); a query that is also a support finds itself at d2 = 0.
//
// Design: one thread per query, kThreads queries per block, grid
// (ceil(Q / kThreads), B). The block stages the support cloud through shared
// memory in tiles of kTile points (structure of arrays, so every thread reads
// the same word: a broadcast, no bank conflicts) and visits supports in
// ascending index order. Each thread keeps its k best as a sorted
// (d2, index) list in registers. A support enters only when its d2 is
// strictly smaller than the current k-th: it has a larger index than every
// entry, so an equal d2 must not displace one. Queries past Q only help
// stage tiles; supports past N are never visited.
//
// Arithmetic: d2 = dx*dx + dy*dy + dz*dz with separate roundings. The library
// is built with --fmad=false so nvcc does not contract it to FMAs; the plain
// version (geot_tpu_torch/ops/knn.py:knn_small_k_ref) rounds the same way,
// which keeps d2 bit-equal and ties identical.
//
// What bounds it: 8 fp32 operations per (query, support) pair, some 1.05
// GFLOP for 16000 x 8192, which is about 16 us at the card's fp32 peak;
// the bytes are a few hundred KB. The simple mapping leaves most SMs idle
// when Q is a few thousand (Q / 128 blocks per cloud) and spends issue slots
// on the compare-and-insert. csrc/knn_split.cu splits the support range
// over several blocks per query tile and merges their lists, and keeps
// several queries per thread to reuse each shared-memory read; it is the
// path's small-k search, and this kernel stays as its first version.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 2048;

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_small_k_kernel(const float* __restrict__ q_all,
                   const float* __restrict__ s_all, float* __restrict__ d_all,
                   int* __restrict__ i_all, int Q, int N) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < Q;
  const float* qp = q_all + ((size_t)b * Q + (active ? q : 0)) * 3;
  const float* sp = s_all + (size_t)b * N * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = __int_as_float(0x7f800000);  // +inf
    bi[s] = N;
  }

  for (int base = 0; base < N; base += kTile) {
    const int n = N - base < kTile ? N - base : kTile;
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < n; j += kThreads) {
      sx[j] = sp[3 * (base + j)];
      sy[j] = sp[3 * (base + j) + 1];
      sz[j] = sp[3 * (base + j) + 2];
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < n; ++j) {
      const float dx = qx - sx[j], dy = qy - sy[j], dz = qz - sz[j];
      const float d = dx * dx + dy * dy + dz * dz;
      if (d < bd[K - 1]) {
        // bubble the candidate into the sorted list; entries it passes
        // move down one slot (their relative order is kept)
        float cd = d;
        int ci = base + j;
#pragma unroll
        for (int s = 0; s < K; ++s) {
          if (cd < bd[s] || (cd == bd[s] && ci < bi[s])) {
            const float td = bd[s];
            const int ti = bi[s];
            bd[s] = cd;
            bi[s] = ci;
            cd = td;
            ci = ti;
          }
        }
      }
    }
  }
  if (!active) return;
  // fewer than K finite d2 (an inf or NaN coordinate): the rest in the
  // plain version's order, by the bits of d2 (+inf, then NaN), then index
  if (bi[K - 1] == N) {
    for (int j = 0; j < N; ++j) {
      const float dx = qx - sp[3 * j], dy = qy - sp[3 * j + 1],
                  dz = qz - sp[3 * j + 2];
      float cd = dx * dx + dy * dy + dz * dz;
      if (cd < __int_as_float(0x7f800000)) continue;   // already listed
      int ci = j;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const unsigned kc = __float_as_uint(cd), ks = __float_as_uint(bd[s]);
        if (bi[s] == N || kc < ks || (kc == ks && ci < bi[s])) {
          const float td = bd[s];
          const int ti = bi[s];
          bd[s] = cd;
          bi[s] = ci;
          cd = td;
          ci = ti;
        }
      }
    }
  }
  float* dp = d_all + ((size_t)b * Q + q) * K;
  int* ip = i_all + ((size_t)b * Q + q) * K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    dp[s] = bd[s];
    ip[s] = bi[s];
  }
}

template <int K>
int launch(const float* q, const float* s, float* d, int* i, int B, int Q,
           int N, cudaStream_t stream) {
  const dim3 grid((Q + kThreads - 1) / kThreads, B);
  knn_small_k_kernel<K><<<grid, kThreads, 0, stream>>>(q, s, d, i, Q, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// k outside 1..4.
extern "C" int geot_knn_small_k(const float* query, const float* support,
                                float* d2, int* idx, int B, int Q, int N,
                                int k, void* stream) {
  if (B <= 0 || Q <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(query, support, d2, idx, B, Q, N, st);
    case 2: return launch<2>(query, support, d2, idx, B, Q, N, st);
    case 3: return launch<3>(query, support, d2, idx, B, Q, N, st);
    case 4: return launch<4>(query, support, d2, idx, B, Q, N, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
