// Exact batched farthest point sampling, (B, N, 3) f32 -> (B, npoint) i32.
//
// Replaces the Pallas TPU kernel geot_tpu/ops/pallas_fps.py:fps_pallas
// (_fps_kernel). Contract: idx[0] = 0; each step sets
// mind = min(mind, |p - last|^2) for every point, with mind starting at 1e10,
// and picks the argmax of mind, ties to the smallest index.
//
// Design: one block of 512 threads per cloud. Thread t owns the points
// t, t + 512, t + 1024, ... The first kSlots of them (N <= 16384) keep their
// xyz in registers and their running min-distance in shared memory; points
// beyond that read xyz from device memory and keep their min-distance in a
// scratch buffer the wrapper allocates. Each step:
//   1. every thread updates its points and keeps only the largest mind
//      (one fmax per point);
//   2. a warp takes the maximum with __reduce_max_sync on the float's bits
//      (mind >= 0, so the bits order like the values), and only the lanes
//      holding that maximum look up their smallest index with it and its
//      xyz; __reduce_min_sync picks the smallest such index;
//   3. the winning lane writes (value, index, xyz) to shared memory, and
//      after the step's one barrier every warp reduces the 16 warp winners
//      the same way and takes the new last point's xyz from the winning
//      entry. The shared slots are double-buffered by step parity, so one
//      barrier per step suffices.
// Padding slots (index >= N) hold mind 0: they never exceed a real point,
// and on a tie their larger index loses.
//
// Arithmetic: d2 = dx*dx + dy*dy + dz*dz with separate roundings. The library
// is built with --fmad=false so nvcc does not contract it to FMAs; the plain
// version (geot_tpu_torch/ops/fps.py:fps_ref) and the JAX reference round the
// same way, which keeps the picked indices bit-equal.
//
// What bounds it: a chain of npoint - 1 dependent block-wide argmax
// reductions on one SM per cloud. The fp32 work (about 1.2 GFLOP for
// 16000 -> 8192) is some 18 us at the card's peak, but one SM issues the
// ~11 instructions per point of every step alone, and each step ends in a
// barrier. At B = 1 one SM of 132 works. csrc/fps_cluster.cu spreads one
// cloud over a thread-block cluster instead and is the path's FPS; this
// kernel runs the clouds too large for a cluster's registers.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 32;                  // points per thread in registers
constexpr int kRegPoints = kThreads * kSlots;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;     // "no index" for min-reductions

struct Entry {
  unsigned key;  // bits of the warp's largest mind
  unsigned i;    // smallest index holding it
  float x, y, z;
};

__global__ void __launch_bounds__(kThreads, 1)
fps_kernel(const float* __restrict__ xyz_all, float* __restrict__ mind_tail_all,
           int* __restrict__ out_all, int N, int npoint) {
  extern __shared__ float s_mind[];          // kRegPoints floats
  __shared__ Entry slots[2][kWarps];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float* xyz = xyz_all + (size_t)b * N * 3;
  int* out = out_all + (size_t)b * npoint;
  const int n_reg = N < kRegPoints ? N : kRegPoints;
  const int n_tail = N - n_reg;
  float* mind_tail = mind_tail_all + (size_t)b * (n_tail > 0 ? n_tail : 0);

  float px[kSlots], py[kSlots], pz[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = t + s * kThreads;
    const bool valid = i < n_reg;
    px[s] = valid ? xyz[3 * i] : 0.f;
    py[s] = valid ? xyz[3 * i + 1] : 0.f;
    pz[s] = valid ? xyz[3 * i + 2] : 0.f;
    s_mind[i] = valid ? 1e10f : 0.f;
  }
  for (int i = n_reg + t; i < N; i += kThreads) mind_tail[i - n_reg] = 1e10f;
  if (t == 0) out[0] = 0;
  // s_mind is only ever touched by its owning thread: no barrier needed

  float lx = xyz[0], ly = xyz[1], lz = xyz[2];
  for (int j = 1; j < npoint; ++j) {
    float bv = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const float dx = px[s] - lx, dy = py[s] - ly, dz = pz[s] - lz;
      const float d2 = dx * dx + dy * dy + dz * dz;
      const float m = fminf(s_mind[t + s * kThreads], d2);
      s_mind[t + s * kThreads] = m;
      bv = fmaxf(bv, m);
    }
    for (int i = n_reg + t; i < N; i += kThreads) {
      const float dx = xyz[3 * i] - lx, dy = xyz[3 * i + 1] - ly,
                  dz = xyz[3 * i + 2] - lz;
      const float d2 = dx * dx + dy * dy + dz * dz;
      const float m = fminf(mind_tail[i - n_reg], d2);
      mind_tail[i - n_reg] = m;
      bv = fmaxf(bv, m);
    }
    // warp: largest mind, then the smallest index holding it
    const unsigned wkey = __reduce_max_sync(kFull, __float_as_uint(bv));
    unsigned li = kNone;
    float bx = 0.f, by = 0.f, bz = 0.f;
    if (__float_as_uint(bv) == wkey) {       // rarely more than one lane
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (li == kNone && s_mind[t + s * kThreads] == bv) {
          li = t + s * kThreads;
          bx = px[s];
          by = py[s];
          bz = pz[s];
        }
      }
      for (int i = n_reg + t; li == kNone && i < N; i += kThreads) {
        if (mind_tail[i - n_reg] == bv) {
          li = i;
          bx = xyz[3 * i];
          by = xyz[3 * i + 1];
          bz = xyz[3 * i + 2];
        }
      }
    }
    const unsigned wi = __reduce_min_sync(kFull, li);
    Entry* buf = slots[j & 1];
    if (li == wi) buf[warp] = Entry{wkey, wi, bx, by, bz};
    __syncthreads();
    // every warp reduces the warp winners itself: no second barrier
    const Entry e = lane < kWarps ? buf[lane] : Entry{0u, kNone, 0.f, 0.f, 0.f};
    const unsigned gkey = __reduce_max_sync(kFull, e.key);
    const unsigned gi = __reduce_min_sync(kFull, e.key == gkey ? e.i : kNone);
    const int src = __ffs(__ballot_sync(kFull, e.i == gi)) - 1;
    lx = __shfl_sync(kFull, e.x, src);
    ly = __shfl_sync(kFull, e.y, src);
    lz = __shfl_sync(kFull, e.z, src);
    if (t == 0) out[j] = static_cast<int>(gi);
  }
}

}  // namespace

// mind_tail: B * max(N - 16384, 0) floats of scratch (may be null when
// N <= 16384). Returns cudaGetLastError() after the launch.
extern "C" int geot_fps(const float* xyz, float* mind_tail, int* out, int B,
                        int N, int npoint, void* stream) {
  if (B <= 0 || npoint <= 0) return 0;
  constexpr int smem = kRegPoints * sizeof(float);   // 64 KB: opt in
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, mind_tail, out, N, npoint);
  return static_cast<int>(cudaGetLastError());
}
