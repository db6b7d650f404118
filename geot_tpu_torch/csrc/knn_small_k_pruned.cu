// Exact fused kNN for k <= 4 on xyz with Morton-chunk pruning:
// (B, Q, 3), (B, N, 3) f32 -> squared d2 and i32 idx, each (B, Q, k).
//
// Replaces the Pallas TPU kernel
// geot_tpu/ops/pallas_knn_pruned.py:knn_small_k_pruned (_kernel). Contract:
// that of knn_small_k.cu, bit for bit: for every query the k supports
// smallest in (d2, original index) order, ascending; ties go to the smaller
// index; a query that is also a support finds itself at d2 = 0.
//
// The plan, on the card (geot_tpu_torch/ops/knn.py:knn_pruned_plan): the
// Morton codes of both clouds in one row, the supports' tagged above the
// queries' (csrc/morton.cu), one stable torch.sort of that row, then
// knn_pruned_prepare_kernel below, which writes the sorted supports as
// float4 (x, y, z, original index as bits) and the box of each chunk of 128
// sorted supports. The search reads the query order itself. The wrapper
// launches the prepare kernel and the search from one call
// (geot_knn_small_k_pruned), so a search costs the host one sort and two
// calls into this library.
//
// What bounds it: 8 fp32 operations per (query, support) pair visited. The
// brute-force bound counts all Q x N pairs; this kernel visits the pairs of
// the few chunks near each query tile, so it can run under that bound. The
// plan's sort costs about as much as the search at the path's shapes, so
// knn_small_k takes this kernel only for the largest searches
// (geot_tpu_torch/ops/knn.py:knn_route).
//
// Design (knn_pruned_kernel): one warp per tile of 32 Morton-consecutive
// queries, blocks of 4 independent warps, no block barrier. Lane l holds query
// l of the tile (slots past Q repeat the last sorted query: they keep the
// tile's bound real and write nothing) and its k best as a sorted (d2,
// original index) list in registers. The warp reduces its tile's box and
// writes each chunk's key (tile-box to chunk-box squared distance bits, chunk
// + 1) into its slice of shared memory; each visit takes the smallest key
// above the last one by a warp min, so the keys are never sorted. The visit
// stops at the first chunk whose distance * 0.99999 exceeds the warp's worst
// k-th best (the rule of pallas_knn_pruned.py:14-20, strict with a margin, so
// exact ties at the k-th place are kept): every later chunk is at least as
// far. A chunk that is past every lane's own k-th best by the query-to-box
// distance is skipped without a scan. A visited chunk comes in with one
// 16-byte load a lane per 32 supports, issued one visit ahead (the next chunk
// loads while this one is scanned), into the warp's slice of shared memory,
// and is read back as broadcasts, 8 supports at a time: their d2 together,
// then, only when some lane has one not past its k-th best, 8 inserts without
// branches (K independent comparisons and a select per slot: `||` there
// compiles to a branch per comparison). Supports arrive in Morton order, not
// index order, so a candidate enters when (d2, index) is lexicographically
// smaller than the k-th entry. Each row is written straight to the caller's
// order through the query's original index. What remains: each warp's visits
// are one serial chain, so the tile that visits the most chunks sets the
// kernel's time.
//
// Arithmetic: d2 = dx*dx + dy*dy + dz*dz with separate roundings (the
// library is built with --fmad=false), as knn_small_k.cu and the plain
// version.
//
// Non-finite d2 (an inf or NaN coordinate): the plain version orders d2 by
// its bits, so +inf and then NaN come after every number, equal bits by
// index. The scan takes +inf in (d2, index) order and never a NaN; a list
// that it leaves short is completed from the NaN d2 in (bits, index) order
// by a second pass over the supports (fill_nan), which runs only for such
// a query. Boxes keep NaN (the plan's min and max propagate it); a chunk
// or tile box with a NaN gets the key 0, so it is visited and never ends
// the visit, and a tile with a NaN query never fills its bound (worst stays
// +inf), so it visits every chunk.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 128;                 // supports per chunk
constexpr int kWarps = 4;                   // warps (query tiles) per block
constexpr int kPrepWarps = 8;               // chunks per prepare block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEmpty = 1 << 30;             // index of an empty slot

__device__ __forceinline__ float nan_min(float a, float b) {
  return (b < a || b != b) ? b : a;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// box[0..2] min, box[3..5] max over the warp, NaN kept
__device__ __forceinline__ void warp_box(float (&box)[6]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      box[d] = nan_min(box[d], __shfl_xor_sync(kFull, box[d], off));
      box[3 + d] = nan_max(box[3 + d], __shfl_xor_sync(kFull, box[3 + d],
                                                       off));
    }
  }
}

// One warp per chunk of 128 sorted supports: the float4 rows and the box.
__global__ void __launch_bounds__(kPrepWarps * 32)
knn_pruned_prepare_kernel(const float* __restrict__ support_all,
                          const long long* __restrict__ order_all,
                          int ord_stride, int ord_base,
                          float4* __restrict__ s4_all,
                          float4* __restrict__ box_all, int N, int NC) {
  const int c = blockIdx.x * kPrepWarps + (threadIdx.x >> 5);
  if (c >= NC) return;                      // the whole warp
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const float* support = support_all + (size_t)b * N * 3;
  const long long* order = order_all + (size_t)b * ord_stride;
  float4* s4 = s4_all + (size_t)b * N;
  const float inf = __int_as_float(0x7f800000);
  float box[6] = {inf, inf, inf, -inf, -inf, -inf};
#pragma unroll
  for (int r = 0; r < kChunk / 32; ++r) {
    const int i = c * kChunk + r * 32 + lane;
    if (i < N) {
      const int p = static_cast<int>(order[i] - ord_base);
      const float x = support[3 * p], y = support[3 * p + 1],
                  z = support[3 * p + 2];
      s4[i] = make_float4(x, y, z, __int_as_float(p));
      box[0] = nan_min(box[0], x);
      box[1] = nan_min(box[1], y);
      box[2] = nan_min(box[2], z);
      box[3] = nan_max(box[3], x);
      box[4] = nan_max(box[4], y);
      box[5] = nan_max(box[5], z);
    }
  }
  warp_box(box);
  if (lane == 0) {
    float4* bx = box_all + ((size_t)b * NC + c) * 2;
    bx[0] = make_float4(box[0], box[1], box[2], 0.f);
    bx[1] = make_float4(box[3], box[4], box[5], 0.f);
  }
}

// After the scan: a slot still empty means fewer than K supports had a
// d2 that is a number or +inf; take the NaN ones in (bits, original
// index) order. Reads the sorted supports again from global memory, and
// only for such a query.
template <int K>
__device__ void fill_nan(float (&bd)[K], int (&bi)[K], float qx, float qy,
                         float qz, const float4* s4, int N) {
  if (bi[K - 1] != kEmpty) return;
  for (int j = 0; j < N; ++j) {
    const float4 s = s4[j];
    const float dx = qx - s.x, dy = qy - s.y, dz = qz - s.z;
    float cd = dx * dx + dy * dy + dz * dz;
    if (cd == cd) continue;                 // a number or +inf: scanned
    int ci = __float_as_int(s.w);
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const unsigned cb = __float_as_uint(cd), sb = __float_as_uint(bd[t]);
      if (bi[t] == kEmpty || cb < sb || (cb == sb && ci < bi[t])) {
        const float td = bd[t];
        const int ti = bi[t];
        bd[t] = cd;
        bi[t] = ci;
        cd = td;
        ci = ti;
      }
    }
  }
}

// The squared distance between the tile's box and chunk box (lo, hi); 0
// when either box holds a NaN (or an infinite extent that makes one).
__device__ __forceinline__ float box_d2(const float (&t)[6], float4 lo,
                                        float4 hi) {
  const float gx = fmaxf(fmaxf(lo.x - t[3], t[0] - hi.x), 0.f);
  const float gy = fmaxf(fmaxf(lo.y - t[4], t[1] - hi.y), 0.f);
  const float gz = fmaxf(fmaxf(lo.z - t[5], t[2] - hi.z), 0.f);
  const float s = lo.x + lo.y + lo.z + hi.x + hi.y + hi.z;
  return s != s ? 0.f : gx * gx + gy * gy + gz * gz;
}

// The squared distance from a query to chunk box (lo, hi): a lower bound
// of its d2 to every support in the chunk; NaN-free (0 where a box
// coordinate is NaN), so a NaN box never lets the chunk be skipped.
__device__ __forceinline__ float point_box_d2(float qx, float qy, float qz,
                                              float4 lo, float4 hi) {
  const float gx = fmaxf(fmaxf(lo.x - qx, qx - hi.x), 0.f);
  const float gy = fmaxf(fmaxf(lo.y - qy, qy - hi.y), 0.f);
  const float gz = fmaxf(fmaxf(lo.z - qz, qz - hi.z), 0.f);
  return gx * gx + gy * gy + gz * gz;
}

// The warp's chunk keys (tile-box distance bits << 32 | chunk + 1) into
// its slice of shared memory: lane l writes chunks l, l + 32, ...
__device__ __forceinline__ void chunk_keys(unsigned long long* keys,
                                           const float (&tb)[6],
                                           bool tile_nan, const float4* bx,
                                           int NC, int lane) {
  for (int c = lane; c < NC; c += 32) {
    const float d = tile_nan ? 0.f : box_d2(tb, bx[2 * c], bx[2 * c + 1]);
    keys[c] = (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
              static_cast<unsigned>(c + 1);
  }
}

// The smallest key above `last`, over the warp; ~0 when there is none.
// The keys stay unsorted: each visit takes the next one by a min.
__device__ __forceinline__ unsigned long long next_key(
    const unsigned long long* keys, int NC, unsigned long long last,
    int lane) {
  unsigned long long best = ~0ull;
#pragma unroll 4
  for (int c = lane; c < NC; c += 32) {
    const unsigned long long key = keys[c];
    if (key > last && key < best) best = key;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, best, off);
    best = o < best ? o : best;
  }
  return best;
}

// Lane l's rows l, l + 32, l + 64, l + 96 of the chunk of `key` (16-byte
// loads, coalesced); rows past N are NaN, whose d2 never enters a list.
__device__ __forceinline__ void load_chunk(float4 (&rows)[kChunk / 32],
                                           const float4* s4,
                                           unsigned long long key, int N,
                                           int lane) {
  if (key == ~0ull) return;
  const int base = (static_cast<int>(key & 0xffffffffu) - 1) * kChunk;
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int r = 0; r < kChunk / 32; ++r) {
    const int j = base + r * 32 + lane;
    rows[r] = j < N ? s4[j] : make_float4(nan, nan, nan, 0.f);
  }
}

// Candidate (d, id) into the sorted list when it is before the k-th entry
// in (d2, index) order, without a branch: the K comparisons are
// independent (lt is monotone over the sorted list), and slot t takes the
// candidate where it is the first one before, the old slot t - 1 after
// that, so an insert is a short chain of selects.
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d,
                                       int id) {
  bool lt[K];
#pragma unroll
  for (int t = 0; t < K; ++t)
    lt[t] = (d < bd[t]) | ((d == bd[t]) & (id < bi[t]));  // no branch
#pragma unroll
  for (int t = K - 1; t > 0; --t) {
    const float nd = lt[t - 1] ? bd[t - 1] : d;
    const int ni = lt[t - 1] ? bi[t - 1] : id;
    bd[t] = lt[t] ? nd : bd[t];
    bi[t] = lt[t] ? ni : bi[t];
  }
  bd[0] = lt[0] ? d : bd[0];
  bi[0] = lt[0] ? id : bi[0];
}

// The 128 rows of the warp's slice against the lane's query, 8 at a time:
// their d2 computed together, then inserted in row order when one of them
// is not past some lane's k-th best (which only shrinks within the group).
template <int K>
__device__ __forceinline__ void scan_chunk(float (&bd)[K], int (&bi)[K],
                                           const float4* slice, float qx,
                                           float qy, float qz) {
  constexpr int kGroup = 8;
#pragma unroll 2
  for (int j0 = 0; j0 < kChunk; j0 += kGroup) {
    float d[kGroup];
    int id[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const float4 s = slice[j0 + u];
      const float dx = qx - s.x, dy = qy - s.y, dz = qz - s.z;
      d[u] = dx * dx + dy * dy + dz * dz;
      id[u] = __float_as_int(s.w);
    }
    bool any = false;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) any |= d[u] <= bd[K - 1];
    if (__any_sync(kFull, any)) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) insert<K>(bd, bi, d[u], id[u]);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
knn_pruned_kernel(const float* __restrict__ q_all,
                  const long long* __restrict__ qord_all, int qord_stride,
                  const float4* __restrict__ s4_all,
                  const float4* __restrict__ box_all,
                  float* __restrict__ d_all, int* __restrict__ i_all,
                  unsigned long long* skipped, int Q, int N, int NT, int NC) {
  __shared__ float4 s_slice[kWarps][kChunk];
  extern __shared__ unsigned long long s_keys[];  // kWarps x NC
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x * kWarps + warp;
  if (tile >= NT) return;                   // the whole warp
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int p = tile * 32 + lane;
  const long long* qord = qord_all + (size_t)b * qord_stride;
  const int qi = static_cast<int>(qord[p < Q ? p : Q - 1]);
  const float* qp = q_all + ((size_t)b * Q + qi) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float4* s4 = s4_all + (size_t)b * N;
  const float4* bx = box_all + (size_t)b * NC * 2;
  float4* slice = s_slice[warp];
  unsigned long long* keys = s_keys + (size_t)warp * NC;

  float tb[6] = {qx, qy, qz, qx, qy, qz};
  warp_box(tb);
  const float ts = tb[0] + tb[1] + tb[2] + tb[3] + tb[4] + tb[5];
  const bool tile_nan = ts != ts;

  const float inf = __int_as_float(0x7f800000);
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = inf;
    bi[s] = kEmpty;
  }
  float worst = inf;
  int visited = 0;
  // the first chunk, loaded ahead: each lane holds 4 of its 128 rows
  chunk_keys(keys, tb, tile_nan, bx, NC, lane);
  __syncwarp();
  unsigned long long key = next_key(keys, NC, 0ull, lane);
  float4 rows[kChunk / 32];
  load_chunk(rows, s4, key, N, lane);
  while (key != ~0ull &&
         !(__uint_as_float(static_cast<unsigned>(key >> 32)) * 0.99999f >
           worst)) {
    // every later chunk is at least this far: stop at the first one past
    // the warp's worst k-th best (above); skip this one when it is past
    // every lane's own k-th best (a point-to-box bound, per lane)
    const int c = static_cast<int>(key & 0xffffffffu) - 1;
    const float pd = point_box_d2(qx, qy, qz, bx[2 * c], bx[2 * c + 1]);
    const bool need = !(pd * 0.99999f > bd[K - 1]);
    const unsigned long long cur = key;
    key = next_key(keys, NC, cur, lane);
    if (!__any_sync(kFull, need)) {
      load_chunk(rows, s4, key, N, lane);
      continue;
    }
    ++visited;
    __syncwarp();                           // the last chunk is read
#pragma unroll
    for (int r = 0; r < kChunk / 32; ++r) slice[r * 32 + lane] = rows[r];
    __syncwarp();
    load_chunk(rows, s4, key, N, lane);     // the next, during the scan
    scan_chunk<K>(bd, bi, slice, qx, qy, qz);
    // the warp's largest k-th best (d2 >= 0 and never NaN here, so the
    // bits order like the values; +inf too)
    worst = __uint_as_float(
        __reduce_max_sync(kFull, __float_as_uint(bd[K - 1])));
  }
  if (skipped != nullptr && lane == 0 && visited < NC)
    atomicAdd(skipped, static_cast<unsigned long long>(NC - visited));
  if (p >= Q) return;
  fill_nan<K>(bd, bi, qx, qy, qz, s4, N);
  float* dp = d_all + ((size_t)b * Q + qi) * K;
  int* ip = i_all + ((size_t)b * Q + qi) * K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    dp[s] = bd[s];
    ip[s] = bi[s];
  }
}

template <int K>
int launch(const float* q, const long long* qord, int qord_stride,
           const float4* s4, const float4* box, float* d, int* i,
           unsigned long long* skipped, int B, int Q, int N, int NT, int NC,
           cudaStream_t stream) {
  const dim3 grid((NT + kWarps - 1) / kWarps, B);
  const int smem = kWarps * NC * static_cast<int>(sizeof(unsigned long long));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_pruned_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  knn_pruned_kernel<K><<<grid, kWarps * 32, smem, stream>>>(
      q, qord, qord_stride, s4, box, d, i, skipped, Q, N, NT, NC);
  return static_cast<int>(cudaGetLastError());
}

int prepare(const float* support, const long long* order, int ord_stride,
            int ord_base, float* s4, float* box, int B, int N,
            cudaStream_t stream) {
  const int NC = (N + kChunk - 1) / kChunk;
  const dim3 grid((NC + kPrepWarps - 1) / kPrepWarps, B);
  knn_pruned_prepare_kernel<<<grid, kPrepWarps * 32, 0, stream>>>(
      support, order, ord_stride, ord_base, reinterpret_cast<float4*>(s4),
      reinterpret_cast<float4*>(box), N, NC);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// support: (B, N, 3); order: row b at order + b * ord_stride, N int64,
// ord_base plus the stable sort of the support's Morton codes; s4: (B, N)
// float4 out; box: (B, NC, 2) float4 out (min xyz, max xyz of each chunk
// of 128 sorted supports), NC = ceil(N / 128). Returns cudaGetLastError()
// after the launch.
extern "C" int geot_knn_pruned_prepare(const float* support,
                                       const long long* order,
                                       int ord_stride, int ord_base,
                                       float* s4, float* box, int B, int N,
                                       void* stream) {
  if (B <= 0 || N <= 0) return 0;
  return prepare(support, order, ord_stride, ord_base, s4, box, B, N,
                 static_cast<cudaStream_t>(stream));
}

// query: (B, Q, 3) in the caller's order; qord: row b at qord + b *
// qord_stride, the stable sort of the query's Morton codes (Q int64); s4,
// box: geot_knn_pruned_prepare's. When support is not null, the prepare
// kernel runs first, over (support, sord, sord_stride, sord_base), into s4
// and box: the plan's last launch and the search from one call. d2, idx:
// (B, Q, k) in the caller's order; skipped: one counter that gets the
// number of (32-query tile, 128-support chunk) pairs not visited, or null.
// Returns cudaGetLastError() after the launches; cudaErrorInvalidValue for
// a k outside 1..4.
extern "C" int geot_knn_small_k_pruned(
    const float* query, const long long* qord, int qord_stride,
    const float* support, const long long* sord, int sord_stride,
    int sord_base, float* s4, float* box, float* d2, int* idx,
    unsigned long long* skipped, int B, int Q, int N, int k, void* stream) {
  if (B <= 0 || Q <= 0) return 0;
  if (N <= 0 || k < 1 || k > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int NT = (Q + 31) / 32;
  const int NC = (N + kChunk - 1) / kChunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (support != nullptr) {
    const int rc = prepare(support, sord, sord_stride, sord_base, s4, box, B,
                           N, st);
    if (rc != 0) return rc;
  }
  const float4* s = reinterpret_cast<const float4*>(s4);
  const float4* bx = reinterpret_cast<const float4*>(box);
  switch (k) {
    case 1: return launch<1>(query, qord, qord_stride, s, bx, d2, idx,
                             skipped, B, Q, N, NT, NC, st);
    case 2: return launch<2>(query, qord, qord_stride, s, bx, d2, idx,
                             skipped, B, Q, N, NT, NC, st);
    case 3: return launch<3>(query, qord, qord_stride, s, bx, d2, idx,
                             skipped, B, Q, N, NT, NC, st);
    default: return launch<4>(query, qord, qord_stride, s, bx, d2, idx,
                              skipped, B, Q, N, NT, NC, st);
  }
}
