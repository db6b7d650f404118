// Exact batched farthest point sampling with Morton-bucket pruning over a
// thread-block cluster, (B, N, 3) f32 -> (B, npoint) i32 original indices,
// N <= C * 44 * 256 (180,224 at C = 16).
//
// Replaces the Pallas TPU kernel geot_tpu/ops/pallas_fps.py:fps_bucket_pallas
// (_fps_bucket_kernel). Contract: that of fps_cluster.cu, bit for bit:
// idx[0] = 0; each step sets mind = min(mind, |p - last|^2) for every point,
// with mind starting at 1e10, and picks the argmax of mind, ties to the
// smallest original index.
//
// The plan, on the card (geot_tpu_torch/ops/fps.py:fps_bucket_plan): the
// cloud's Morton codes (csrc/morton.cu) and their stable torch.sort. The
// kernel gathers the sorted cloud itself.
//
// What bounds it: a chain of npoint - 1 dependent argmax steps, as
// fps_cluster.cu; the distance work is 9 fp32 operations per point and
// step, of which the pruning skips most once the picks spread out.
//
// Design: one cluster of C blocks of 512 threads per cloud (C <= 16, grid
// (C, B)). Block rank r owns the sorted positions [r * per_cta, (r + 1) *
// per_cta), in buckets of 256 points, and keeps them in shared memory as
// float4 (x, y, z, mind) with each point's original index beside them:
// 20 bytes a point, 44 buckets in the 227 KB a block may use. Per bucket
// the block also keeps its box (over its real points) and its winner: the
// largest mind, the smallest original index holding it and its slot. Each
// step:
//   1. warp w takes buckets w, w + 16, ...: a bucket whose box is farther
//      from the last pick than its largest mind (box_d2 * 0.99999 >= max,
//      the TPU kernel's margin) cannot change and keeps its winner; the
//      warp updates any other bucket (8 points a lane) and reduces its new
//      winner, (mind desc, original index asc): rank order is not index
//      order, so the index goes with the key (read only for the winning
//      slot, or for every slot holding the largest mind when it is tied);
//   2. after the block barrier warp 0 reduces the bucket winners the same
//      way and takes the winner's xyz from its slot;
//   3. the cluster exchange of fps_cluster.cu, copied: lanes r < C of warp 0
//      send the block winner (key, original index, xyz) into slot
//      [parity][own rank] of block r with st.async, counted on that block's
//      mbarrier for this step parity; every thread waits on its own block's
//      mbarrier and reduces the C entries in (key desc, index asc) order.
// Only rank 0 writes out[j].
//
// Why the skip is exact: for a point inside the box, each rounded |x - px|
// is at least the rounded box gap on that axis (rounding is monotonic), so
// the point's rounded d2 is at least the box's rounded d2, which is at
// least the bucket's largest mind; min(mind, d2) is then mind. Boxes skip
// NaN coordinates (fminf, fmaxf), as the update does: fminf(mind, NaN) is
// mind, in this kernel and in fps_cluster.cu alike.
//
// Arithmetic: d2 = dx*dx + dy*dy + dz*dz with separate roundings under
// --fmad=false, as fps_cluster.cu and the plain version fps_ref.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBucket = 256;
constexpr int kPer = kBucket / 32;          // points per lane per bucket
constexpr int kMaxBuckets = 44;             // per block
constexpr int kMaxCluster = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;     // "no index" for min-reductions

struct __align__(16) Entry {
  unsigned key;  // bits of the block's largest mind
  unsigned i;    // smallest original index holding it
  float x, y, z;
};

// --- the cluster exchange, as in fps_cluster.cu -----------------------------

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
  cluster_sync();
}

// --- buckets ----------------------------------------------------------------

__device__ __forceinline__ float box_d2(const float* bx, float px, float py,
                                        float pz) {
  const float dx = fmaxf(fmaxf(bx[0] - px, px - bx[3]), 0.f);
  const float dy = fmaxf(fmaxf(bx[1] - py, py - bx[4]), 0.f);
  const float dz = fmaxf(fmaxf(bx[2] - pz, pz - bx[5]), 0.f);
  return dx * dx + dy * dy + dz * dz;
}

// (key, index) a is before b: larger key, then smaller index
__device__ __forceinline__ bool before(unsigned ka, unsigned ia, unsigned kb,
                                       unsigned ib) {
  return (ka > kb) | ((ka == kb) & (ia < ib));  // no branch
}

// The shared-memory layout of a block with nbk buckets.
struct Smem {
  float4* pts;       // nbk * 256: x, y, z, mind (-1 for padding)
  unsigned* oidx;    // nbk * 256: original index (kNone for padding)
  float* box;        // nbk * 6: min xyz, max xyz of the real points
  float* bval;       // nbk: the bucket's largest mind
  unsigned* bidx;    // nbk: the smallest original index holding it
  int* bpos;         // nbk: its slot
};

__device__ __forceinline__ Smem carve(unsigned char* base, int nbk) {
  Smem s;
  s.pts = reinterpret_cast<float4*>(base);
  s.oidx = reinterpret_cast<unsigned*>(s.pts + nbk * kBucket);
  s.box = reinterpret_cast<float*>(s.oidx + nbk * kBucket);
  s.bval = s.box + nbk * 6;
  s.bidx = reinterpret_cast<unsigned*>(s.bval + nbk);
  s.bpos = reinterpret_cast<int*>(s.bidx + nbk);
  return s;
}

constexpr int smem_bytes(int nbk) {
  return nbk * (kBucket * 20 + 6 * 4 + 3 * 4);
}

__global__ void __launch_bounds__(kThreads, 1)
fps_bucket_kernel(const float* __restrict__ xyz_all,
                  const long long* __restrict__ order_all,
                  int* __restrict__ out_all,
                  unsigned long long* __restrict__ skipped, int N,
                  int npoint, int per_cta, int nbk) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  __shared__ Entry cslot[2][kMaxCluster];
  __shared__ uint64_t bar[2];

  const unsigned C = cluster_size();
  const unsigned rank = cluster_rank();
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float* xyz = xyz_all + (size_t)b * N * 3;
  const long long* order = order_all + (size_t)b * N;
  int* out = out_all + (size_t)b * npoint;
  const int lo = min(N, static_cast<int>(rank) * per_cta);
  const int n_local = min(N - lo, per_cta);
  const int nreal = (n_local + kBucket - 1) / kBucket;
  const Smem s = carve(s_raw, nbk);

  // the block's sorted points, gathered
  for (int i = t; i < nreal * kBucket; i += kThreads) {
    if (i < n_local) {
      const int p = static_cast<int>(order[lo + i]);
      s.pts[i] = make_float4(xyz[3 * p], xyz[3 * p + 1], xyz[3 * p + 2],
                             1e10f);
      s.oidx[i] = static_cast<unsigned>(p);
    } else {
      s.pts[i] = make_float4(0.f, 0.f, 0.f, -1.f);
      s.oidx[i] = kNone;
    }
  }
  __syncthreads();
  // each real bucket's box and first winner (every mind is 1e10)
  for (int bk = warp; bk < nreal; bk += kWarps) {
    const float inf = __int_as_float(0x7f800000);
    float bmin[3] = {inf, inf, inf}, bmax[3] = {-inf, -inf, -inf};
    unsigned mi = kNone;
    int mpos = -1;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = bk * kBucket + q * 32 + lane;
      if (s.oidx[i] != kNone) {
        const float4 v = s.pts[i];
        bmin[0] = fminf(bmin[0], v.x);
        bmin[1] = fminf(bmin[1], v.y);
        bmin[2] = fminf(bmin[2], v.z);
        bmax[0] = fmaxf(bmax[0], v.x);
        bmax[1] = fmaxf(bmax[1], v.y);
        bmax[2] = fmaxf(bmax[2], v.z);
        if (s.oidx[i] < mi) {
          mi = s.oidx[i];
          mpos = i;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        bmin[d] = fminf(bmin[d], __shfl_xor_sync(kFull, bmin[d], off));
        bmax[d] = fmaxf(bmax[d], __shfl_xor_sync(kFull, bmax[d], off));
      }
    }
    const unsigned wi = __reduce_min_sync(kFull, mi);
    const int src = __ffs(__ballot_sync(kFull, mi == wi)) - 1;
    const int wpos = __shfl_sync(kFull, mpos, src);
    if (lane == 0) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        s.box[bk * 6 + d] = bmin[d];
        s.box[bk * 6 + 3 + d] = bmax[d];
      }
      s.bval[bk] = 1e10f;
      s.bidx[bk] = wi;
      s.bpos[bk] = wpos;
    }
  }
  exchange_setup(bar, C);   // its cluster barrier also orders the above
  if (rank == 0 && t == 0) out[0] = 0;

  float lx = xyz[0], ly = xyz[1], lz = xyz[2];
  unsigned long long n_skip = 0;
  for (int j = 1; j < npoint; ++j) {
    // 1. the buckets that can change
    for (int bk = warp; bk < nreal; bk += kWarps) {
      if (!(box_d2(s.box + bk * 6, lx, ly, lz) * 0.99999f < s.bval[bk])) {
        ++n_skip;
        continue;
      }
      // the lane's largest mind, its first slot and how many slots hold
      // it: no original index is read unless the warp's largest value is
      // held more than once
      float bv = -2.f;
      int bs = -1, cnt = 0;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int i = bk * kBucket + q * 32 + lane;
        const float4 v = s.pts[i];
        const float dx = v.x - lx, dy = v.y - ly, dz = v.z - lz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        const float m = fminf(v.w, d2);
        s.pts[i].w = m;
        if (m > bv) {
          bv = m;
          bs = i;
          cnt = 1;
        } else if (m == bv) {
          ++cnt;
        }
      }
      // padding holds mind -1: key 0 and no index, after any real point
      const bool real = bv >= 0.f;
      const unsigned key = real ? __float_as_uint(bv) : 0u;
      const unsigned wkey = __reduce_max_sync(kFull, key);
      const bool mine = real && key == wkey;
      const unsigned holders = __ballot_sync(kFull, mine);
      unsigned wi;
      int wpos;
      if (__popc(holders) == 1 && !__any_sync(kFull, mine && cnt > 1)) {
        wpos = __shfl_sync(kFull, bs, __ffs(holders) - 1);
        wi = s.oidx[wpos];
      } else {
        // a tie: the smallest original index among the slots holding wkey
        unsigned li = kNone;
        int lpos = -1;
        if (mine) {
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            const int i = bk * kBucket + q * 32 + lane;
            if (s.pts[i].w == bv && s.oidx[i] < li) {
              li = s.oidx[i];
              lpos = i;
            }
          }
        }
        wi = __reduce_min_sync(kFull, li);
        wpos = __shfl_sync(kFull, lpos,
                           __ffs(__ballot_sync(kFull, li == wi)) - 1);
      }
      if (lane == 0) {
        s.bval[bk] = __uint_as_float(wkey);
        s.bidx[bk] = wi;
        s.bpos[bk] = wpos;
      }
    }
    __syncthreads();
    // 2. warp 0: the block's winner over its buckets
    Entry e{0u, kNone, 0.f, 0.f, 0.f};
    if (warp == 0) {
      unsigned key = 0u, idx = kNone;
      int pos = -1;
      for (int bk = lane; bk < nreal; bk += 32) {
        const unsigned k2 = __float_as_uint(s.bval[bk]), i2 = s.bidx[bk];
        if (before(k2, i2, key, idx)) {
          key = k2;
          idx = i2;
          pos = s.bpos[bk];
        }
      }
      e.key = __reduce_max_sync(kFull, key);
      e.i = __reduce_min_sync(kFull, key == e.key ? idx : kNone);
      const int src = __ffs(__ballot_sync(kFull, key == e.key &&
                                                     idx == e.i)) - 1;
      pos = __shfl_sync(kFull, pos, src < 0 ? 0 : src);
      if (e.i != kNone) {
        const float4 v = s.pts[pos];
        e.x = v.x;
        e.y = v.y;
        e.z = v.z;
      }
    }
    // 3. the cluster's winner
    const Entry g = exchange(cslot, bar, j, C, rank, warp == 0, e);
    lx = g.x;
    ly = g.y;
    lz = g.z;
    if (rank == 0 && t == 0) out[j] = static_cast<int>(g.i);
  }
  if (skipped != nullptr && lane == 0 && n_skip > 0)
    atomicAdd(skipped, n_skip);
  cluster_sync();   // no block leaves while a peer may still reach it
}

cudaError_t prepare(int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      fps_bucket_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      fps_bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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

}  // namespace

// xyz: (B, N, 3) in the caller's order; order: (B, N) int64, the stable
// sort of the cloud's Morton codes; skipped: one counter that gets the
// number of (step, bucket) updates skipped, or null. C in 1..16 blocks a
// cloud, each owning per_cta sorted points in ceil(per_cta / 256) <= 44
// buckets, C * per_cta >= N. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for arguments outside those.
extern "C" int geot_fps_bucket(const float* xyz, const long long* order,
                               int* out, unsigned long long* skipped, int B,
                               int N, int npoint, int C, int per_cta,
                               void* stream) {
  if (B <= 0 || npoint <= 0) return 0;
  const int nbk = (per_cta + kBucket - 1) / kBucket;
  if (C < 1 || C > kMaxCluster || per_cta < 1 || nbk > kMaxBuckets
      || static_cast<long long>(C) * per_cta < N)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(nbk);
  cudaError_t err = prepare(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(
      C, B, smem, static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, fps_bucket_kernel, xyz, order, out, skipped,
                           N, npoint, per_cta, nbk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of C blocks with the full 44 buckets the card runs at
// once, into *count.
extern "C" int geot_fps_bucket_max_active(int C, int* count) {
  const int smem = smem_bytes(kMaxBuckets);
  cudaError_t err = prepare(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(C, 1, smem, nullptr, attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(count,
                                                         fps_bucket_kernel,
                                                         &cfg));
}
