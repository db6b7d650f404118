// Exact batched farthest point sampling with Morton-bucket pruning,
// (B, N, 3) f32 -> (B, npoint) i32 original indices, N <= 30 * 1024.
//
// Replaces the Pallas TPU kernel geot_tpu/ops/pallas_fps.py:fps_bucket_pallas
// (_fps_bucket_kernel). Contract: that of fps.cu, bit for bit: idx[0] = 0;
// each step sets mind = min(mind, |p - last|^2) for every point, with mind
// starting at 1e10, and picks the argmax of mind, ties to the smallest
// original index.
//
// Input, prepared by the wrapper (geot_tpu_torch/ops/fps.py:fps_bucket) in
// plain PyTorch: the cloud sorted by Morton code and padded to nb buckets of
// 1024 points, the original index of every sorted slot (1 << 30 for a
// padded slot) and each bucket's bounding box over its real points.
//
// Design: one block of 512 threads (16 warps) per cloud; warp w owns buckets
// w and w + 16. Lane l of a warp holds points l, l + 32, ..., l + 992 of a
// bucket: the xyz of its first bucket in registers, of its second (only
// when nb > 16) read from device memory; the running min-distance of every
// point lives in shared memory. Each step, for each of its buckets, a warp
// first tests the bucket's box against the bucket's running max of mind:
// if boxd2 * 0.99999 >= bmax, no point of the bucket can get a smaller
// mind than the largest it has, so mind is unchanged and the bucket is
// skipped. Otherwise the warp updates the bucket's mind, takes its max and
// the smallest original index holding it. The per-bucket winners (value,
// original index, xyz) are double-buffered in shared memory by step parity;
// after the step's one barrier every warp reduces the <= 30 winners,
// lexicographically (value desc, original index asc), itself.
//
// Why the skip is exact: for a point inside the box, each rounded |x - px|
// is at least the rounded box gap on that axis (rounding is monotonic), so
// the point's rounded d2 is at least the box's rounded d2; the 1e-5 margin
// of the TPU kernel is kept. Mind starts at 1e10 for real points and -1 for
// padding, so padding never wins; bmax starts at 1e30 so that the first
// step updates every bucket.
//
// Arithmetic: d2 = dx*dx + dy*dy + dz*dz with separate roundings (the
// library is built with --fmad=false), as fps.cu and the plain version.
//
// What bounds it: as fps.cu, the chain of npoint - 1 dependent block-wide
// argmax steps on one SM per cloud. Pruning removes distance updates (late
// in the run most buckets are skipped), not the per-step barrier and
// reduction, which are what the chain is made of on this card.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBucket = 1024;
constexpr int kPer = kBucket / 32;          // points per lane per bucket
constexpr int kMaxBuckets = 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kSent = 1u << 30;        // original index of padding
constexpr unsigned kNone = 0xffffffffu;

struct Entry {
  float v;       // the bucket's largest mind
  unsigned i;    // smallest original index holding it
  float x, y, z;
};

// float -> unsigned with the same order, for __reduce_max_sync
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float box_d2(const float* bx, float px, float py,
                                        float pz) {
  const float dx = fmaxf(fmaxf(bx[0] - px, px - bx[3]), 0.f);
  const float dy = fmaxf(fmaxf(bx[1] - py, py - bx[4]), 0.f);
  const float dz = fmaxf(fmaxf(bx[2] - pz, pz - bx[5]), 0.f);
  return dx * dx + dy * dy + dz * dz;
}

// Update one bucket's mind against the last pick and return its new winner.
// Every lane of the warp returns the same entry.
template <bool kRegs>
__device__ __forceinline__ Entry update_bucket(
    float* __restrict__ mind, const float* __restrict__ sxyz,
    const int* __restrict__ order, const float (&px)[kPer],
    const float (&py)[kPer], const float (&pz)[kPer], int lane, float lx,
    float ly, float lz) {
  float bv = -2.f;
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    const int i = s * 32 + lane;
    float x, y, z;
    if (kRegs) {
      x = px[s];
      y = py[s];
      z = pz[s];
    } else {
      x = sxyz[3 * i];
      y = sxyz[3 * i + 1];
      z = sxyz[3 * i + 2];
    }
    const float dx = x - lx, dy = y - ly, dz = z - lz;
    const float d2 = dx * dx + dy * dy + dz * dz;
    const float m = fminf(mind[i], d2);
    mind[i] = m;
    bv = fmaxf(bv, m);
  }
  const unsigned wkey = __reduce_max_sync(kFull, order_key(bv));
  unsigned li = kNone;
  float wx = 0.f, wy = 0.f, wz = 0.f;
  if (order_key(bv) == wkey) {
    // ties inside the lane go to the smallest ORIGINAL index, which is not
    // the smallest sorted slot
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int i = s * 32 + lane;
      if (mind[i] == bv) {
        const unsigned oi = static_cast<unsigned>(order[i]);
        if (oi < li) {
          li = oi;
          if (kRegs) {
            wx = px[s];
            wy = py[s];
            wz = pz[s];
          } else {
            wx = sxyz[3 * i];
            wy = sxyz[3 * i + 1];
            wz = sxyz[3 * i + 2];
          }
        }
      }
    }
  }
  const unsigned wi = __reduce_min_sync(kFull, li);
  const int src = __ffs(__ballot_sync(kFull, li == wi)) - 1;
  Entry e;
  e.v = __shfl_sync(kFull, bv, src);
  e.i = wi;
  e.x = __shfl_sync(kFull, wx, src);
  e.y = __shfl_sync(kFull, wy, src);
  e.z = __shfl_sync(kFull, wz, src);
  return e;
}

__global__ void __launch_bounds__(kThreads, 1)
fps_bucket_kernel(const float* __restrict__ xyz_all,
                  const float* __restrict__ sxyz_all,
                  const int* __restrict__ order_all,
                  const float* __restrict__ box_all, int* __restrict__ out_all,
                  unsigned long long* __restrict__ skipped, int N, int nb,
                  int npoint) {
  extern __shared__ float s_mind[];                 // nb * kBucket floats
  __shared__ Entry slots[2][kMaxBuckets];
  __shared__ float s_box[kMaxBuckets][6];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int np = nb * kBucket;
  const float* sxyz = sxyz_all + (size_t)b * np * 3;
  const int* order = order_all + (size_t)b * np;
  int* out = out_all + (size_t)b * npoint;
  const int b0 = warp, b1 = warp + kWarps;
  const bool has0 = b0 < nb, has1 = b1 < nb;

  float px[kPer], py[kPer], pz[kPer];
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    const int i = b0 * kBucket + s * 32 + lane;
    px[s] = has0 ? sxyz[3 * i] : 0.f;
    py[s] = has0 ? sxyz[3 * i + 1] : 0.f;
    pz[s] = has0 ? sxyz[3 * i + 2] : 0.f;
  }
  for (int i = t; i < np; i += kThreads)
    s_mind[i] = static_cast<unsigned>(order[i]) < kSent ? 1e10f : -1.f;
  for (int i = t; i < nb * 6; i += kThreads)
    s_box[i / 6][i % 6] = box_all[(size_t)b * nb * 6 + i];
  if (t < nb) slots[0][t] = Entry{1e30f, kSent, 0.f, 0.f, 0.f};
  if (t == 0) out[0] = 0;
  __syncthreads();

  float lx = xyz_all[(size_t)b * N * 3], ly = xyz_all[(size_t)b * N * 3 + 1],
        lz = xyz_all[(size_t)b * N * 3 + 2];
  unsigned long long n_skip = 0;
  for (int j = 1; j < npoint; ++j) {
    Entry* cur = slots[j & 1];
    const Entry* prev = slots[(j - 1) & 1];
    if (has0) {
      Entry e = prev[b0];
      if (box_d2(s_box[b0], lx, ly, lz) * 0.99999f < e.v) {
        e = update_bucket<true>(s_mind + b0 * kBucket, nullptr,
                                order + b0 * kBucket, px, py, pz, lane, lx,
                                ly, lz);
      } else {
        ++n_skip;
      }
      if (lane == 0) cur[b0] = e;
    }
    if (has1) {
      Entry e = prev[b1];
      if (box_d2(s_box[b1], lx, ly, lz) * 0.99999f < e.v) {
        e = update_bucket<false>(s_mind + b1 * kBucket,
                                 sxyz + (size_t)b1 * kBucket * 3,
                                 order + b1 * kBucket, px, py, pz, lane, lx,
                                 ly, lz);
      } else {
        ++n_skip;
      }
      if (lane == 0) cur[b1] = e;
    }
    __syncthreads();
    // every warp reduces the bucket winners itself: no second barrier
    const bool real = lane < nb;
    const Entry e = real ? cur[lane] : Entry{0.f, kNone, 0.f, 0.f, 0.f};
    const unsigned key = real ? order_key(e.v) : 0u;
    const unsigned gkey = __reduce_max_sync(kFull, key);
    const unsigned gi = __reduce_min_sync(kFull, key == gkey ? e.i : kNone);
    const int src = __ffs(__ballot_sync(kFull, real && key == gkey &&
                                                   e.i == gi)) - 1;
    lx = __shfl_sync(kFull, e.x, src);
    ly = __shfl_sync(kFull, e.y, src);
    lz = __shfl_sync(kFull, e.z, src);
    if (t == 0) out[j] = static_cast<int>(gi);
  }
  if (skipped != nullptr && lane == 0 && n_skip > 0)
    atomicAdd(skipped, n_skip);
}

}  // namespace

// xyz: (B, N, 3) in caller order (for the first pick, original index 0);
// sxyz: (B, nb * 1024, 3) Morton-sorted and padded; order: (B, nb * 1024)
// original index of each sorted slot, 1 << 30 for padding; box: (B, nb, 6)
// per-bucket (min xyz, max xyz) of the real points; skipped: one counter
// that gets the number of (step, bucket) updates skipped, or null.
// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for
// nb outside 1..30.
extern "C" int geot_fps_bucket(const float* xyz, const float* sxyz,
                               const int* order, const float* box, int* out,
                               unsigned long long* skipped, int B, int N,
                               int nb, int npoint, void* stream) {
  if (B <= 0 || npoint <= 0) return 0;
  if (nb < 1 || nb > kMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = nb * kBucket * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fps_bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_bucket_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, sxyz, order, box, out, skipped, N, nb, npoint);
  return static_cast<int>(cudaGetLastError());
}
