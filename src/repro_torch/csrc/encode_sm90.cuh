// Shared sm_90a code of the two encodes (diff_encode.cu, diff_encode_fused.cu):
// the class of a 128 x 128 tile of delta = x_t - x_prev,
//   0 if max|delta| == 0,  1 if max|delta| <= low_max,  else 2,
// with each tile split over a thread-block cluster of C blocks.
//
// Geometry. C is 1, 2, 4 or 8 (portable cluster sizes that divide the
// tile's 128 rows); the grid is (C * K/128, M/128, batch) in (C, 1, 1)
// clusters, so a cluster is one class tile and block r of it
// (blockIdx.x % C) loads rows [r * 128/C, (r + 1) * 128/C) of the tile:
// 128-byte rows in 16-byte vectors, a warp four whole rows, every load of
// a thread issued before any is used. A block has at most 256 threads and
// every thread at least one vector of each operand (Geometry<C>).
//
// Reduction. A thread keeps a running per-byte max of |delta|
// (__vabsdiffs4: exact, |delta| <= 255 fits the unsigned byte); a warp
// reduces it with __reduce_max_sync, the block through shared memory.
// Across the cluster every block pushes its maximum into every other
// block's shared memory with st.async (distributed shared memory), which
// signals the receiving block's mbarrier with the 4 bytes it wrote; a block
// waits on its own mbarrier for the C - 1 maxima, so every thread knows the
// class after one exchange, and block 0 writes the int32 class. The
// mbarrier is set up at kernel start, before the one cluster barrier of
// the kernel, whose arrive is issued there and whose wait comes just before
// the push, behind the loads: no push reaches a block before its mbarrier
// is set up. That wait is also what keeps a block resident until every
// push into it has landed, so no cluster barrier guards the exit (the
// value pushed is a register: the sender's exit does not depend on it).
// (Pulling the maxima with cluster.sync() and map_shared_rank instead, two
// full cluster barriers on the critical path, cost 0.7-0.8 us a launch
// more on the H100, more than the split saves: PERF.md.)
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace ditto {
namespace encode {

constexpr int TILE = 128;  // class tiles are TILE x TILE

template <int C>
struct Geometry {
  static_assert(C == 1 || C == 2 || C == 4 || C == 8, "a portable cluster dividing TILE");
  static constexpr int ROWS = TILE / C;               // tile rows a block loads
  static constexpr int BLOCK_VECS = ROWS * TILE / 16;  // 16-byte vectors of each operand
  static constexpr int THREADS = BLOCK_VECS < 256 ? BLOCK_VECS : 256;
  static constexpr int VECS = BLOCK_VECS / THREADS;   // a thread's vectors of each operand
  static constexpr int WARPS = THREADS / 32;
  static_assert(WARPS <= 32, "one warp reduces the block's warp maxima");
};

// Where a block works: the element offset of its first row in x_t / x_prev
// (column 0 of its tile), the index of its tile's class, its cluster rank.
struct Slab {
  int64_t off;
  int64_t cls_at;
  int rank;
};

template <int C>
__device__ __forceinline__ Slab slab_of(int64_t k, int64_t sx, int64_t sc) {
  const int rank = blockIdx.x % C;
  const int64_t tj = blockIdx.x / C, ti = blockIdx.y, b = blockIdx.z;
  return {b * sx + (ti * TILE + rank * Geometry<C>::ROWS) * k + tj * TILE,
          b * sc + ti * (k / TILE) + tj, rank};
}

// Element offset, from the slab's first element, of this thread's vector i.
template <int C>
__device__ __forceinline__ int64_t vec_at(int i, int64_t k) {
  const int v = threadIdx.x + i * Geometry<C>::THREADS;
  return int64_t(v >> 3) * k + (v & 7) * 16;
}

template <int C>
__device__ __forceinline__ void load_slab(const int8_t* __restrict__ xt,
                                          const int8_t* __restrict__ xp, const Slab& s,
                                          int64_t k, uint4 (&a)[Geometry<C>::VECS],
                                          uint4 (&p)[Geometry<C>::VECS]) {
#pragma unroll
  for (int i = 0; i < Geometry<C>::VECS; ++i) {
    a[i] = *reinterpret_cast<const uint4*>(xt + s.off + vec_at<C>(i, k));
    p[i] = *reinterpret_cast<const uint4*>(xp + s.off + vec_at<C>(i, k));
  }
}

// max|a - p| over the 16 signed byte lanes of a vector pair, folded into a
// running per-byte max.
__device__ __forceinline__ uint32_t absdiff_max16(uint4 a, uint4 p, uint32_t acc) {
  acc = __vmaxu4(acc, __vabsdiffs4(a.x, p.x));
  acc = __vmaxu4(acc, __vabsdiffs4(a.y, p.y));
  acc = __vmaxu4(acc, __vabsdiffs4(a.z, p.z));
  return __vmaxu4(acc, __vabsdiffs4(a.w, p.w));
}

template <int C>
__device__ __forceinline__ int slab_max(const uint4 (&a)[Geometry<C>::VECS],
                                        const uint4 (&p)[Geometry<C>::VECS]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < Geometry<C>::VECS; ++i) acc = absdiff_max16(a[i], p[i], acc);
  acc = __vmaxu4(acc, acc >> 16);
  acc = __vmaxu4(acc, acc >> 8);
  return int(acc & 0xffu);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of `addr` (a shared::cta address) in block `rank`.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // .acquire
}

// A block's shared memory for the reduction.
template <int C>
struct TileMax {
  uint64_t bar;                      // mbarrier: the other blocks' maxima have landed
  int warp_max[Geometry<C>::WARPS];  // this block's warps
  int block_max[C];                  // every block's, by cluster rank
};

// At kernel start, every thread: the mbarrier expects (C - 1) * 4 bytes.
template <int C>
__device__ __forceinline__ void tile_begin(TileMax<C>& t) {
  if constexpr (C > 1) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&t.bar)) : "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(smem_u32(&t.bar)), "r"((C - 1) * 4) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_arrive_relaxed();
  }
}

// The tile's max|delta| from every thread's own, in every thread of the
// cluster. Every thread calls it once, after tile_begin.
template <int C>
__device__ __forceinline__ int tile_max(int amax, TileMax<C>& t, int rank) {
  constexpr int WARPS = Geometry<C>::WARPS;
  const int lane = threadIdx.x & 31;
  amax = __reduce_max_sync(0xffffffffu, amax);
  if (lane == 0) t.warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  int m = __reduce_max_sync(0xffffffffu, lane < WARPS ? t.warp_max[lane] : 0);
  if constexpr (C > 1) {
    cluster_wait();  // every block of the cluster has set up its mbarrier
    if (threadIdx.x < C && int(threadIdx.x) != rank)
      asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];\n"
                   ::"r"(mapa(smem_u32(&t.block_max[rank]), threadIdx.x)), "r"(m),
                   "r"(mapa(smem_u32(&t.bar), threadIdx.x)) : "memory");
    for (uint32_t done = 0; !done;)
      asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                   "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(smem_u32(&t.bar)) : "memory");
#pragma unroll
    for (int q = 0; q < C; ++q)
      if (q != rank) m = max(m, t.block_max[q]);
  }
  return m;
}

__device__ __forceinline__ int tile_class(int amax, int low_max) {
  return amax == 0 ? 0 : (amax <= low_max ? 1 : 2);
}

// Launch kernel<C> (void(KArgs...)) over the tiles of a (batch, m, k)
// operand pair on `stream` with (C, 1, 1) clusters.
template <int C, class... KArgs, class... Args>
int launch_tiles(void (*kernel)(KArgs...), int64_t batch, int64_t m, int64_t k, void* stream,
                 Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(C * (k / TILE)), unsigned(m / TILE), unsigned(batch));
  cfg.blockDim = dim3(Geometry<C>::THREADS);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? int(e) : int(cudaGetLastError());
}

// f(std::integral_constant<int, C>{}) for a cluster size known at run time;
// -1 for a size the kernels do not have.
template <class F>
int with_cluster(int cluster, F&& f) {
  switch (cluster) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return -1;
  }
}

}  // namespace encode
}  // namespace ditto
