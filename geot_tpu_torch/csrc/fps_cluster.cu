// Exact batched farthest point sampling over a thread-block cluster,
// (B, N, 3) f32 -> (B, npoint) i32.
//
// Replaces the Pallas TPU kernel geot_tpu/ops/pallas_fps.py:fps_pallas
// (_fps_kernel), as csrc/fps.cu does, with the same contract bit for bit:
// idx[0] = 0; each step sets mind = min(mind, |p - last|^2) for every point,
// with mind starting at 1e10, and picks the argmax of mind, ties to the
// smallest index.
//
// What bounds it: a chain of npoint - 1 dependent argmax steps. fps.cu runs
// one cloud on one SM (one 512-thread block), and its 2.4 us per step is the
// issue work of 16,000 points on one SM plus the block's serial tail
// (shared-memory min-distances, the winner look-up, the barrier).
//
// Design: one cluster of C blocks (C <= 16, grid (C, B)) per cloud. Block
// rank r owns the contiguous index range [r * per_cta, (r + 1) * per_cta),
// so rank order is index order and the tie rule survives the merge. Thread
// t of a block owns the points lo + t + s * 256, s < kSlots, and keeps their
// xyz and min-distance in registers; the block's points are also staged in
// shared memory, so the block winner's xyz is one load. Each step:
//   1. every thread updates its points and keeps the first largest mind
//      (strict >, slots in index order); padding slots hold mind -1 and
//      never win;
//   2. a warp takes the largest key with __reduce_max_sync on the float's
//      bits (mind >= 0 orders like its bits) and the smallest index holding
//      it with __reduce_min_sync; warp 0 reduces the 8 warp winners after
//      the block barrier, the same way;
//   3. lanes r < C of warp 0 send the block winner (key, index, xyz) into
//      slot [parity][own rank] of block r's shared memory (DSMEM) with
//      st.async, which counts its bytes on block r's mbarrier for this step
//      parity when they land (complete_tx); every thread waits on its own
//      block's mbarrier, which one thread re-arms for C entries' bytes after
//      each step. No release fence and no arrive by the writer: on an H100
//      SXM at 700 W a cluster barrier (0.60-0.87 us a step at C = 2-16) and
//      remote mbarrier arrives (0.52-0.67) both cost a round trip, st.async
//      0.18-0.27 us one way;
//   4. every warp reduces the C entries in (key desc, index asc) order and
//      takes the new last point's xyz from the winning entry; no second
//      barrier, since slots and mbarriers are double-buffered by parity.
// Only rank 0 writes out[j].
// What bounds this design is that per-step latency: the exchange and the
// block's reductions, not the distance work (about 1,000 points per block
// at C = 16).
//
// Arithmetic: d2 = dx*dx + dy*dy + dz*dz with separate roundings under
// --fmad=false, as fps.cu and the plain version fps_ref.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kMaxSlots = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;     // "no index" for min-reductions

struct __align__(16) Entry {
  unsigned key;  // bits of the block's largest mind
  unsigned i;    // smallest index holding it
  float x, y, z;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

// the address of the same shared variable in block `rank` of the cluster
__device__ __forceinline__ unsigned peer_addr(const void* p, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// entry e into `slot` of block `rank`, its bytes counted on that block's
// mbarrier `bar`
__device__ __forceinline__ void put_entry_async(Entry* slot, uint64_t* bar,
                                                unsigned rank,
                                                const Entry& e) {
  const unsigned a = peer_addr(slot, rank);
  const unsigned m = peer_addr(bar, rank);
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%2, %3, %4, %5}, [%1];\n"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
      "[%0+16], %6, [%1];"
      :: "r"(a), "r"(m), "r"(e.key), "r"(e.i), "r"(__float_as_uint(e.x)),
         "r"(__float_as_uint(e.y)), "r"(__float_as_uint(e.z))
      : "memory");
}

constexpr unsigned kEntryBytes = 20;   // what put_entry_async sends

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Steps 3 and 4 above for lanes of warp 0 holding the block's entry `e`;
// every thread of the block calls it. Returns the cluster's winner to every
// thread.
__device__ __forceinline__ Entry exchange(Entry (*cslot)[kMaxCluster],
                                          uint64_t* bar, int j, unsigned C,
                                          unsigned rank, bool writer,
                                          const Entry& e) {
  const int par = j & 1;
  const unsigned lane = threadIdx.x & 31;
  if (writer && lane < C)
    put_entry_async(&cslot[par][rank], &bar[par], lane, e);
  mbar_wait(&bar[par], static_cast<unsigned>((j - 1) >> 1) & 1u);
  // re-arm for step j + 2: its bytes come only after every block has sent
  // its step j + 1 entry, so after every thread here passed this wait (the
  // block's entry for j + 1 follows a __syncthreads)
  if (threadIdx.x == 0) mbar_expect(&bar[par], C * kEntryBytes);
  const Entry c = lane < C ? cslot[par][lane] : Entry{0u, kNone, 0.f, 0.f,
                                                      0.f};
  const unsigned gkey = __reduce_max_sync(kFull, c.key);
  const unsigned gi = __reduce_min_sync(kFull, c.key == gkey ? c.i : kNone);
  const int src = __ffs(__ballot_sync(kFull, lane < C && c.i == gi)) - 1;
  return Entry{gkey, gi, __shfl_sync(kFull, c.x, src),
               __shfl_sync(kFull, c.y, src), __shfl_sync(kFull, c.z, src)};
}

__device__ __forceinline__ void exchange_setup(uint64_t* bar, unsigned C) {
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_expect(&bar[0], C * kEntryBytes);
    mbar_expect(&bar[1], C * kEntryBytes);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every block of the cluster runs and its mbarriers are set up before
  // any block touches a peer's shared memory
  cluster_sync();
}

template <int kSlots>
__global__ void __launch_bounds__(kThreads, 1)
fps_cluster_kernel(const float* __restrict__ xyz_all, int* __restrict__ out_all,
                   int N, int npoint, int per_cta) {
  extern __shared__ float s_xyz[];           // 3 * per_cta floats
  __shared__ Entry cslot[2][kMaxCluster];
  __shared__ uint2 wslot[2][kWarps];
  __shared__ uint64_t bar[2];

  const unsigned C = cluster_size();
  const unsigned rank = cluster_rank();
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float* xyz = xyz_all + (size_t)b * N * 3;
  int* out = out_all + (size_t)b * npoint;
  const int lo = static_cast<int>(rank) * per_cta;
  const int n_local = max(0, min(N - lo, per_cta));

  float px[kSlots], py[kSlots], pz[kSlots], md[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = t + s * kThreads;
    const bool valid = i < n_local;
    const float* p = xyz + 3 * (size_t)(lo + (valid ? i : 0));
    px[s] = valid ? p[0] : 0.f;
    py[s] = valid ? p[1] : 0.f;
    pz[s] = valid ? p[2] : 0.f;
    md[s] = valid ? 1e10f : -1.f;
  }
  for (int i = t; i < 3 * n_local; i += kThreads) s_xyz[i] = xyz[3 * lo + i];
  exchange_setup(bar, C);
  if (rank == 0 && t == 0) out[0] = 0;

  float lx = xyz[0], ly = xyz[1], lz = xyz[2];
  for (int j = 1; j < npoint; ++j) {
    const int par = j & 1;
    float bv = -1.f;
    int bs = -1;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const float dx = px[s] - lx, dy = py[s] - ly, dz = pz[s] - lz;
      const float d2 = dx * dx + dy * dy + dz * dz;
      md[s] = fminf(md[s], d2);
      if (md[s] > bv) {
        bv = md[s];
        bs = s;
      }
    }
    // warp: largest key, then the smallest index holding it
    const unsigned key = bs >= 0 ? __float_as_uint(bv) : 0u;
    const unsigned idx = bs >= 0 ? static_cast<unsigned>(lo + t + bs * kThreads)
                                 : kNone;
    const unsigned wkey = __reduce_max_sync(kFull, key);
    const unsigned wi = __reduce_min_sync(kFull, key == wkey ? idx : kNone);
    if (lane == 0) wslot[par][warp] = make_uint2(wkey, wi);
    __syncthreads();
    // block: warp 0 reduces the warp winners and looks up the xyz
    Entry e{0u, kNone, 0.f, 0.f, 0.f};
    if (warp == 0) {
      const uint2 w = lane < kWarps ? wslot[par][lane] : make_uint2(0u, kNone);
      e.key = __reduce_max_sync(kFull, w.x);
      e.i = __reduce_min_sync(kFull, w.x == e.key ? w.y : kNone);
      if (e.i != kNone && lane < static_cast<int>(C)) {
        const float* p = s_xyz + 3 * (e.i - lo);
        e.x = p[0];
        e.y = p[1];
        e.z = p[2];
      }
    }
    const Entry g = exchange(cslot, bar, j, C, rank, warp == 0, e);
    lx = g.x;
    ly = g.y;
    lz = g.z;
    if (rank == 0 && t == 0) out[j] = static_cast<int>(g.i);
  }
  cluster_sync();   // no block leaves while a peer may still reach it
}

// The exchange alone: npoint - 1 steps of the block barrier, write-to-peers,
// synchronisation and reduction of the C entries, with no distance work. Its
// time over npoint - 1 is the per-step floor of fps_cluster_kernel.
__global__ void __launch_bounds__(kThreads, 1)
cluster_exchange_kernel(int* __restrict__ out_all, int npoint) {
  __shared__ Entry cslot[2][kMaxCluster];
  __shared__ uint64_t bar[2];
  const unsigned C = cluster_size();
  const unsigned rank = cluster_rank();
  int* out = out_all + (size_t)blockIdx.y * npoint;
  exchange_setup(bar, C);
  unsigned last = 0;
  for (int j = 1; j < npoint; ++j) {
    // a key that depends on the last winner, so no step can run ahead
    const unsigned key = (last * 2654435761u + rank * 40503u + j) >> 8;
    const Entry e{key, rank, 0.f, 0.f, 0.f};
    // as in fps_cluster_kernel: no warp sends step j + 1 before every warp
    // of the block is past step j's wait
    __syncthreads();
    last = exchange(cslot, bar, j, C, rank, threadIdx.x < 32, e).i;
    if (rank == 0 && threadIdx.x == 0) out[j] = static_cast<int>(last);
  }
  cluster_sync();
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

cudaLaunchConfig_t config(int C, int B, int smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int kSlots>
int launch(const float* xyz, int* out, int B, int N, int npoint, int C,
           int per_cta, cudaStream_t stream) {
  auto kernel = fps_cluster_kernel<kSlots>;
  const int smem = 3 * per_cta * static_cast<int>(sizeof(float));
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(C, B, smem, stream, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, xyz, out, N, npoint, per_cta);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C in 2..16, slots in {2, 4, 8, 16} with per_cta <= 256 * slots and
// C * per_cta >= N. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments outside those.
extern "C" int geot_fps_cluster(const float* xyz, int* out, int B, int N,
                                int npoint, int C, int per_cta, int slots,
                                void* stream) {
  if (B <= 0 || npoint <= 0) return 0;
  if (C < 1 || C > kMaxCluster || per_cta < 1 || per_cta > kThreads * slots
      || static_cast<long long>(C) * per_cta < N)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (slots) {
    case 2: return launch<2>(xyz, out, B, N, npoint, C, per_cta, st);
    case 4: return launch<4>(xyz, out, B, N, npoint, C, per_cta, st);
    case 8: return launch<8>(xyz, out, B, N, npoint, C, per_cta, st);
    case 16: return launch<16>(xyz, out, B, N, npoint, C, per_cta, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// How many clusters of C blocks of the largest configuration (16 slots,
// its full shared memory) the card runs at once, into *count.
extern "C" int geot_fps_cluster_max_active(int C, int* count) {
  auto kernel = fps_cluster_kernel<kMaxSlots>;
  const int smem = 3 * kThreads * kMaxSlots * static_cast<int>(sizeof(float));
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(C, 1, smem, nullptr, attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(count, kernel, &cfg));
}

// The exchange alone over B clusters of C blocks, npoint - 1 steps; out
// (B, npoint) gets each step's winning rank.
extern "C" int geot_cluster_exchange(int* out, int B, int npoint, int C,
                                     void* stream) {
  if (B <= 0 || npoint <= 0) return 0;
  if (C < 1 || C > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(C, B, 0,
                                        static_cast<cudaStream_t>(stream),
                                        attr);
  cudaError_t err = prepare(cluster_exchange_kernel, 0);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, cluster_exchange_kernel, out, npoint);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
