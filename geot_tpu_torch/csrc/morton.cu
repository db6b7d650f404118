// Morton (Z-order) codes of point clouds, 10 bits an axis over each cloud's
// bounding box: (B, N, 3) f32 -> (B, N) i32, bit-equal to the plain version
// geot_tpu_torch/ops/morton.py:morton_codes (and so to
// geot_tpu/ops/morton.py:morton_codes).
//
// Replaces no Pallas kernel: geot_tpu computes the codes in XLA, outside the
// pallas_calls of fps_bucket_pallas and knn_small_k_pruned, as the first
// part of those kernels' plans. The port keeps the plans on the card, and
// this is their first launch (then torch.sort, then the kernels of
// csrc/fps_bucket.cu and csrc/knn_small_k_pruned.cu).
//
// Arithmetic, as the plain version: the box is the min and max over the
// cloud, NaN if any coordinate on that axis is NaN (torch.amin/amax);
// extent = max(max - min, 1e-9) with NaN kept; scale = 1023 / extent
// (IEEE division); q = (int)clamp((x - min) * scale, 0, 1023), each
// operation rounded on its own (--fmad=false); a NaN there becomes 0, as
// the card's float-to-int conversion of a NaN does in the plain version.
//
// Design: one cluster of 8 blocks of 512 threads per cloud, up to two
// clouds per launch (the query and the support of a search). The kNN plan
// has both clouds' codes written into one row per batch entry, the
// support's with bit 30 set (above a code's 30 bits), so that one stable
// sort orders both: the queries first, then the supports. Each block
// reduces the box of its eighth of the cloud, the blocks read each other's
// partial boxes through distributed shared memory, and each then writes its
// eighth's codes. What bounds it: bytes, 12 read (twice, the second time
// mostly from L2) and 4 written a point.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;
constexpr unsigned kFull = 0xffffffffu;

// min and max that keep a NaN, as torch.amin and torch.amax
__device__ __forceinline__ float nan_min(float a, float b) {
  return (b < a || b != b) ? b : a;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ unsigned spread3(unsigned v) {
  v &= 0x3FFu;
  v = (v | (v << 16)) & 0x30000FFu;
  v = (v | (v << 8)) & 0x300F00Fu;
  v = (v | (v << 4)) & 0x30C30C3u;
  v = (v | (v << 2)) & 0x9249249u;
  return v;
}

__device__ __forceinline__ unsigned quantise(float x, float mn, float scale) {
  const float v = fminf(fmaxf((x - mn) * scale, 0.f), 1023.f);  // NaN -> 0
  return static_cast<unsigned>(static_cast<int>(v));
}

// box[0..2] min, box[3..5] max; reduced over the warp
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

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
morton_kernel(const float* __restrict__ xyz_a, int* __restrict__ code_a,
              int na, const float* __restrict__ xyz_b,
              int* __restrict__ code_b, int nb, int stride_a, int stride_b,
              unsigned tag_b) {
  __shared__ float s_warp[kWarps][6];
  __shared__ float s_part[6];
  __shared__ float s_box[6];
  cg::cluster_group cluster = cg::this_cluster();
  const bool second = blockIdx.z == 1;
  const int N = second ? nb : na;
  const float* xyz = (second ? xyz_b : xyz_a) + (size_t)blockIdx.y * N * 3;
  int* code = (second ? code_b : code_a) +
              (size_t)blockIdx.y * (second ? stride_b : stride_a);
  const unsigned tag = second ? tag_b : 0u;
  const int rank = static_cast<int>(cluster.block_rank());
  const int per = (N + kCluster - 1) / kCluster;
  const int lo = min(N, rank * per), hi = min(N, lo + per);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float inf = __int_as_float(0x7f800000);

  float box[6] = {inf, inf, inf, -inf, -inf, -inf};
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float v = xyz[3 * i + d];
      box[d] = nan_min(box[d], v);
      box[3 + d] = nan_max(box[3 + d], v);
    }
  }
  warp_box(box);
  if (lane == 0) {
#pragma unroll
    for (int d = 0; d < 6; ++d) s_warp[warp][d] = box[d];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int d = 0; d < 6; ++d)
      box[d] = lane < kWarps ? s_warp[lane][d] : (d < 3 ? inf : -inf);
    warp_box(box);
    if (lane == 0) {
#pragma unroll
      for (int d = 0; d < 6; ++d) s_part[d] = box[d];
    }
  }
  cluster.sync();  // every block's partial box is written
  if (warp == 0) {
    // lane r < 8 reads block r's partial box
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      box[d] = d < 3 ? inf : -inf;
      if (lane < kCluster) box[d] = *cluster.map_shared_rank(&s_part[d], lane);
    }
    warp_box(box);
    if (lane == 0) {
#pragma unroll
      for (int d = 0; d < 6; ++d) s_box[d] = box[d];
    }
  }
  cluster.sync();  // no block leaves while a peer reads it; s_box is set
  float mn[3], scale[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    mn[d] = s_box[d];
    float e = s_box[3 + d] - mn[d];
    e = e != e ? e : fmaxf(e, 1e-9f);
    scale[d] = 1023.0f / e;
  }
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    const unsigned qx = quantise(xyz[3 * i], mn[0], scale[0]);
    const unsigned qy = quantise(xyz[3 * i + 1], mn[1], scale[1]);
    const unsigned qz = quantise(xyz[3 * i + 2], mn[2], scale[2]);
    code[i] = static_cast<int>(spread3(qx) | (spread3(qy) << 1) |
                               (spread3(qz) << 2) | tag);
  }
}

}  // namespace

// Codes of B clouds of na points (xyz_a -> code_a, rows stride_a ints
// apart) and, when xyz_b is not null, of B clouds of nb points (xyz_b ->
// code_b, rows stride_b apart, each code or'ed with tag_b), in one launch.
// Returns cudaGetLastError() after the launch.
extern "C" int geot_morton_codes(const float* xyz_a, int* code_a, int na,
                                 const float* xyz_b, int* code_b, int nb,
                                 int B, int stride_a, int stride_b,
                                 unsigned tag_b, void* stream) {
  if (B <= 0) return 0;
  if (na < 1 || (xyz_b != nullptr && nb < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(kCluster, B, xyz_b != nullptr ? 2 : 1);
  morton_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz_a, code_a, na, xyz_b, code_b, nb, stride_a, stride_b, tag_b);
  return static_cast<int>(cudaGetLastError());
}
