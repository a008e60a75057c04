// Shared sm_90a mainloop of the three int8 GEMMs: the two difference GEMMs
// (ditto_diff_matmul.cu, ditto_fused_matmul.cu)
//
//   out[b] = y_prev[b] + delta[b] @ W[b]          (exact int32)
//
// where delta is rebuilt in registers from raw operand bytes by a producer
// (DiffProducer: x_t - x_prev; FusedProducer: the Δ-cache lo + 16 * dh),
// and the act GEMM (int8_matmul.cu: ActProducer, A = x as it is, no
// y_prev). W[b] is K-major, (N, K): int8 wgmma reads B only so.
//
// Geometry. One 128-thread block (one warpgroup) computes a 64 x 128 output
// tile over one K range with wgmma.m64n128k32 s8 x s8 -> s32, A from
// registers and B from shared memory; three blocks fit an SM, so several
// independent pipelines share each SM's memory and tensor cores. K may be
// split across the blocks of a thread-block cluster (grid.x = cluster.x =
// splits) at 128-K class-tile boundaries: split z takes class tiles
// [z * kt / splits, (z + 1) * kt / splits), kt = K / 128. choose_splits
// picks the count from the launch's shape and the card's SM count.
//
// Classes. A block reads its row of class tiles once and compacts the
// live ones (class != 0) into a list in shared memory; the pipeline walks
// only live 64-K chunks, so no chunk waits on a class read and no class-0
// byte is ever staged. A producer without classes (P::CLASSED false: the
// act GEMM) reads none and lists every class tile of its split.
//
// Pipeline. A STAGES-deep ring of raw operand bytes (the producer's A
// bytes and the 64 x 128 W chunk) is filled with cp.async 16-byte copies,
// STAGES - 1 chunks ahead of the one being multiplied. A thread builds
// its A fragments straight from the staged raw bytes (the wgmma register
// fragment is the mma.m16n8k32 A fragment of the thread's warp), so Δ
// never goes back to shared memory. Δ lies in [-254, 254]: a fragment word
// whose four lanes are all in [-127, 127] is its own lo plane with hi = 0;
// a word with a lane outside takes the exact split lo = clamp(Δ, ±127),
// hi = Δ - lo (split_delta4). The warpgroup votes whether any hi lane of the
// chunk is non-zero and issues the hi product only then. The act GEMM's A
// is the staged x itself (P::A_SMEM): wgmma reads it from shared memory
// through a second descriptor, as it reads W, and no thread touches it.
//
// Shared-memory layout. Every staged plane keeps its rows whole (64 bytes
// of K, 32 for the packed dc plane) with the 16-byte columns XOR-swizzled
// by row (row64 / row32), so that a warp's 16-byte cp.async writes and its
// fragment reads both touch every bank once. For W this is exactly the
// K-major 64-byte-swizzle layout wgmma reads B in.
//
// Epilogue. Every block writes its (partial) tile to shared memory. An
// unsplit block then reads it back a whole row a warp, adds y_prev and
// stores, in 16-byte vectors. Split blocks wait on a cluster barrier; block
// r of the cluster sums the tile's 16-byte vectors {r, r + splits, ...}
// over every block's shared memory (distributed shared memory), adds y_prev
// and stores the same way. Integer addition is associative, so the split
// result is bit-identical to one pass.
#pragma once

#include <atomic>

#include <cooperative_groups.h>

#include "int4_pack.cuh"

namespace ditto {
namespace sm90 {

namespace cg = cooperative_groups;

constexpr int GM = 64;             // output tile rows (wgmma M)
constexpr int GN = 128;            // output tile cols (wgmma N)
constexpr int GK = 64;             // K bytes per pipeline chunk
constexpr int CLASS_K = 128;       // K extent of one class tile
constexpr int CLASS_M = 128;       // M extent of one class tile
constexpr int GTHREADS = 128;      // one warpgroup
constexpr int STAGES = 3;
constexpr int MAX_TILES = 64;      // class tiles one split may hold (the s_live list)
constexpr int MAX_SPLITS = 8;      // blocks of one cluster (portable cluster size)
constexpr int SPLIT_TILES = 9;     // class tiles a split walks on a full grid (choose_splits)
constexpr int SPLIT_SAVES = 3;     // class tiles a split must save on a part-idle grid
constexpr int W_BYTES = GK * GN;   // one W chunk, 8 KB
constexpr int C_PITCH = GN + 8;    // int32 pitch of the staged output tile

struct GemmArgs {
  const int8_t* a0;  // x_t | dc | x
  const int8_t* a1;  // x_prev | dh | unused
  const int8_t* w;
  const int32_t* classes;  // null without classes (P::CLASSED false)
  const int32_t* y_prev;  // may be null
  int32_t* out;
  int64_t m, n, k;
  int64_t sa0, sa1, sw, so, sc;  // batch strides, elements
  int splits;
  int low4;
};

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's generic-proxy shared-memory writes (cp.async, st.shared)
// visible to the async proxy that wgmma reads B through.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte k (0..63) of row r of a plane of 64-byte rows, 16-byte columns
// XOR-swizzled by (r / 2) % 4: the hardware's 64-byte swizzle when the
// plane starts on a 512-byte boundary.
__device__ __forceinline__ int row64(int r, int k) {
  return r * 64 + (((k >> 4) ^ ((r >> 1) & 3)) << 4) + (k & 15);
}

// Byte k (0..31) of row r of a plane of 32-byte rows, swizzled by (r / 4) % 2.
__device__ __forceinline__ int row32(int r, int k) {
  return r * 32 + (((k >> 4) ^ ((r >> 2) & 1)) << 4) + (k & 15);
}

// Descriptor of a K-major operand tile (B: W's 128 rows; A_SMEM: x's 64)
// of 64-byte rows in the 64-byte swizzle (layout type 2): 8-row groups 512
// bytes apart (stride byte offset); the leading byte offset is unused for
// a swizzled K-major operand. p points at K byte 0 or 32 of row 0.
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(512 >> 4) << 32) | (uint64_t(2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d += A(64 x 32, this thread's fragment a) @ B(32 x 128, descriptor)
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d += A(64 x 32, descriptor) @ B(32 x 128, descriptor)
__device__ __forceinline__ void wgmma_s8_ss(int32_t (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Keep the compiler from moving accumulator reads across wgmma_wait_all.
__device__ __forceinline__ void fence_acc(int32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ------------------------------------------------------ SIMD byte helpers
// x - y in each byte lane, mod 256 (no borrow between lanes).
__device__ __forceinline__ uint32_t sub_bytes(uint32_t x, uint32_t y) {
  return ((x | 0x80808080u) - (y & 0x7f7f7f7fu)) ^ ((x ^ ~y) & 0x80808080u);
}

// Nonzero iff some byte lane of v is 0x80 (-128): a zero-byte test of v ^ 0x80.
__device__ __forceinline__ uint32_t has_byte_80(uint32_t v) {
  const uint32_t x = v ^ 0x80808080u;
  return (x - 0x01010101u) & ~x & 0x80808080u;
}

// Sign-extend the low nibble of every byte lane: the pack -> unpack round
// trip of int4_pack on four lanes, exact for lanes in [-8, 7].
__device__ __forceinline__ uint32_t nibble_lanes(uint32_t v) {
  const uint32_t u = v & 0x0f0f0f0fu;
  return u | ((u & 0x08080808u) * 30u);  // 8 * 30 = 0xf0 per set lane, no carries
}

// Two packed int4 x 2 bytes (bits 0-15 of p) -> their four raw nibbles, one
// a byte lane in K order (unsigned, 0..15).
__device__ __forceinline__ uint32_t spread_nibbles(uint32_t p) {
  const uint32_t t = __byte_perm(p, 0u, 0x1100);  // bytes b0, b0, b1, b1
  return (t & 0x000f000fu) | ((t >> 4) & 0x0f000f00u);
}

// ------------------------------------------------------------- the kernel
// A fragment coordinates: register q of k-step s holds K bytes
// 32 s + 16 (q / 2) + 4 t4 .. + 3 of row (q & 1 ? row1 : row0).
__device__ __forceinline__ int frag_k(int s, int q, int t4) {
  return 32 * s + 16 * (q >> 1) + 4 * t4;
}

// Stage W's chunk (K bytes [k0, k0 + 64) x cols [n0, n0 + 128)) of the
// (N, K) weight as 128 swizzled 64-byte rows.
__device__ __forceinline__ void load_w(uint8_t* dst, const GemmArgs& a, const int8_t* w,
                                       int64_t n0, int64_t k0) {
#pragma unroll
  for (int it = 0; it < W_BYTES / 16 / GTHREADS; ++it) {
    const int v = threadIdx.x + it * GTHREADS;
    const int nn = v >> 2, kc = v & 3;
    cp_async16(dst + row64(nn, kc * 16), w + (n0 + nn) * a.k + k0 + kc * 16);
  }
}

// P (the producer) supplies:
//   CLASSED                      whether a.classes gates the class tiles;
//   A_SMEM                       whether A is its staged bytes as they are
//                                (64 swizzled 64-byte rows), read by wgmma
//                                from shared memory; frags is then unused;
//   A_BYTES                      its raw bytes per stage;
//   load(stage, a, b, m0, k0, cls)  cp.async of those bytes for one chunk;
//   frags(stage, a, cls, row0, t4, lo, hi, any) -> bool
//                                builds the lo (and hi) fragments of the
//                                chunk's two k-steps; returns whether a hi
//                                product is possible (uniform over the
//                                block), with `any` nonzero where this
//                                thread holds a non-zero hi lane.
template <class P>
struct Layout {
  static constexpr int STAGE_BYTES = P::A_BYTES + W_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
  static_assert(P::A_BYTES % 1024 == 0, "stage regions stay 1 KB aligned");
  static_assert(GM * C_PITCH * 4 <= SMEM_BYTES, "the output tile reuses the ring");
};

template <class P>
__global__ void __launch_bounds__(GTHREADS, 3)
    diff_gemm_kernel(const __grid_constant__ GemmArgs a) {
  using L = Layout<P>;
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ int s_live[MAX_TILES];  // live class tile | class << 16
  __shared__ int s_nlive;
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x;
  const int64_t b = blockIdx.z;
  const int64_t tiles_n = a.n / GN;
  const int64_t mt = blockIdx.y / tiles_n, nt = blockIdx.y % tiles_n;
  const int64_t m0 = mt * GM, n0 = nt * GN;
  const int kt = int(a.k / CLASS_K);
  const int kb = split * kt / a.splits, ke = (split + 1) * kt / a.splits;
  const int8_t* w = a.w + b * a.sw;

  if (warp == 0) {  // compact this split's live class tiles
    const int32_t* cls_row = P::CLASSED ? a.classes + b * a.sc + (m0 / CLASS_M) * kt : nullptr;
    int cnt = 0;
    for (int base = kb; base < ke; base += 32) {
      const int t = base + lane;
      const int c = t >= ke ? 0 : P::CLASSED ? cls_row[t] : 1;
      const uint32_t live = __ballot_sync(0xffffffffu, c != 0);
      if (c != 0) s_live[cnt + __popc(live & ((1u << lane) - 1u))] = t | (c << 16);
      cnt += __popc(live);
    }
    if (lane == 0) s_nlive = cnt;
  }
  __syncthreads();
  const int nchunks = 2 * s_nlive;
  auto issue = [&](int c) {
    const int e = s_live[c >> 1];
    const int64_t k0 = int64_t(e & 0xffff) * CLASS_K + (c & 1) * GK;
    uint8_t* st = smem + (c % STAGES) * L::STAGE_BYTES;
    P::load(st, a, b, m0, k0, e >> 16);
    load_w(st + P::A_BYTES, a, w, n0, k0);
  };

  int32_t acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) issue(s);
    cp_async_commit();
  }
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 16 + g;
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();
    fence_async_shared();
    __syncthreads();  // chunk c landed; every thread is done with chunk c - 1
    const uint8_t* st = smem + (c % STAGES) * L::STAGE_BYTES;
    const uint8_t* wb = st + P::A_BYTES;
    const uint64_t d0 = b_desc(wb), d1 = b_desc(wb + 32);
    if constexpr (P::A_SMEM) {  // A read by wgmma from the staged rows
      wgmma_fence();
      wgmma_s8_ss(acc, b_desc(st), d0);
      wgmma_s8_ss(acc, b_desc(st + 32), d1);
    } else {
      const int cls = s_live[c >> 1] >> 16;
      uint32_t lo[2][4], hi[2][4], any = 0;
      const bool may_hi = P::frags(st, a, cls, row0, t4, lo, hi, any);
      wgmma_fence();
      wgmma_s8(acc, lo[0], d0);
      wgmma_s8(acc, lo[1], d1);
      if (may_hi && __syncthreads_or(any != 0)) {  // the vote overlaps the lo product
        wgmma_s8(acc, hi[0], d0);
        wgmma_s8(acc, hi[1], d1);
      }
    }
    wgmma_commit();
    // refill the stage chunk c - 1 used while the tensor cores work on chunk c
    if (c + STAGES - 1 < nchunks) issue(c + STAGES - 1);
    cp_async_commit();
    wgmma_wait_all();
    fence_acc(acc);
  }
  cp_async_wait<0>();
  int32_t* out = a.out + b * a.so;
  const int32_t* yp = a.y_prev == nullptr ? nullptr : a.y_prev + b * a.so;
  __syncthreads();  // the ring is idle: reuse it for the output tile

  int32_t* ct = reinterpret_cast<int32_t*>(smem);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * t4;
    *reinterpret_cast<int2*>(ct + row0 * C_PITCH + col) = make_int2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<int2*>(ct + (row0 + 8) * C_PITCH + col) =
        make_int2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  // This block stores the tile's 16-byte vectors tid + 128 i for the i
  // with i % splits == rank (all of them when unsplit), a warp a whole
  // 512-byte row; their y_prev loads are all issued before the barrier, so
  // their latency overlaps it.
  const int splits = a.splits, rank = splits == 1 ? 0 : int(cluster.block_rank());
  constexpr int VECS = GM * GN / 4 / GTHREADS;
  int4 y[VECS];
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    const int v = tid + GTHREADS * i;
    y[i] = make_int4(0, 0, 0, 0);
    if (yp != nullptr && i % splits == rank)
      y[i] = __ldg(reinterpret_cast<const int4*>(yp + (m0 + (v >> 5)) * a.n + n0 +
                                                 (v & 31) * 4));
  }
  if (splits == 1) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < VECS; ++i) {
      const int v = tid + GTHREADS * i, r = v >> 5, c4 = (v & 31) * 4;
      const int4 p = *reinterpret_cast<const int4*>(ct + r * C_PITCH + c4);
      *reinterpret_cast<int4*>(out + (m0 + r) * a.n + n0 + c4) =
          make_int4(y[i].x + p.x, y[i].y + p.y, y[i].z + p.z, y[i].w + p.w);
    }
    return;
  }
  cluster.sync();  // every split's partial tile is in its shared memory
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    if (i % splits != rank) continue;
    const int v = tid + GTHREADS * i, r = v >> 5, c4 = (v & 31) * 4;
    int4 p[MAX_SPLITS];
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q)
      if (q < splits)
        p[q] = *reinterpret_cast<const int4*>(cluster.map_shared_rank(ct, q) + r * C_PITCH + c4);
    int4 s = y[i];
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q)
      if (q < splits) {
        s.x += p[q].x;
        s.y += p[q].y;
        s.z += p[q].z;
        s.w += p[q].w;
      }
    *reinterpret_cast<int4*>(out + (m0 + r) * a.n + n0 + c4) = s;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// K splits of a launch of `tiles` output tiles (batch included) over kt
// class tiles on a card with `sms` SMs. A grid with a block for every SM
// splits only a long walk, into splits of about SPLIT_TILES class tiles. A
// grid that leaves SMs idle takes the split with the shortest walk that
// keeps at most two blocks an SM, if that at least halves the walk and
// saves SPLIT_SAVES class tiles or more (a cluster's reduction costs about
// that). Fitted to the difference GEMMs' split sweep
// (benchmarks/torch_diff_gemm_sweep.py) at DiT-XL/2's shapes for 1, 2
// and 4 requests; the act GEMM shares it (its sweep is in PERF.md).
// Raised where one split would hold more class tiles than the live list;
// 0 when a cluster is too few.
inline int choose_splits(int64_t tiles, int64_t kt, int sms) {
  int64_t s = 1;
  if (tiles >= sms) {
    s = kt / SPLIT_TILES > 1 ? kt / SPLIT_TILES : 1;
  } else {
    int64_t walk = kt;
    for (int64_t c = 2; c <= MAX_SPLITS && c <= kt && tiles * c <= 2 * sms; ++c)
      if ((kt + c - 1) / c < walk) {
        s = c;
        walk = (kt + c - 1) / c;
      }
    if (2 * walk > kt || kt - walk < SPLIT_SAVES) s = 1;
  }
  s = s < kt ? s : kt;
  s = s < MAX_SPLITS ? s : MAX_SPLITS;
  const int64_t need = (kt + MAX_TILES - 1) / MAX_TILES;
  s = s > need ? s : need;
  return s > MAX_SPLITS ? 0 : int(s);
}

// The kernel's K split for a (batch, m, n, k) launch on the current device:
// 0 when K needs more class tiles than a cluster holds, the negated CUDA
// error where the device query fails.
inline int launch_splits(int64_t batch, int64_t m, int64_t n, int64_t k) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -int(e);
  return choose_splits(batch * (m / GM) * (n / GN), k / CLASS_K, sms);
}

// Launch on `stream` with a (splits, 1, 1) cluster: a.splits == 0 takes
// launch_splits, a positive a.splits forces the count (the split sweep).
// Returns the CUDA error, or -1 for a split count the kernel cannot run.
template <class P>
int launch_diff_gemm(GemmArgs a, int64_t batch, void* stream) {
  auto kernel = diff_gemm_kernel<P>;
  constexpr int smem = Layout<P>::SMEM_BYTES;
  if (a.splits == 0) {
    a.splits = launch_splits(batch, a.m, a.n, a.k);
    if (a.splits < 0) return -a.splits;
  }
  const int64_t kt = a.k / CLASS_K;
  if (a.splits < 1 || a.splits > MAX_SPLITS || a.splits > kt ||
      (kt + a.splits - 1) / a.splits > MAX_TILES)
    return -1;
  // dynamic shared memory above 48 KB, allowed once per device (idempotent,
  // so two threads racing to set it is harmless)
  static std::atomic<uint64_t> sized{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  const uint64_t bit = uint64_t(1) << (dev & 63);
  if (!(sized.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
    sized.fetch_or(bit, std::memory_order_relaxed);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(a.splits), unsigned((a.m / GM) * (a.n / GN)), unsigned(batch));
  cfg.blockDim = dim3(GTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(a.splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? int(e) : int(cudaGetLastError());
}

}  // namespace sm90
}  // namespace ditto
