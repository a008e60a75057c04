// Tile-skipping temporal-difference GEMM, batched, for sm_90a:
//   out[b] = y_prev[b] + (x_t[b] - x_prev[b]) @ W[b]        (exact int32)
//
// Replaces src/repro/kernels/ditto_diff_matmul.py: ditto_diff_matmul (the
// Pallas body _kernel, both low_bits branches). The mainloop, pipeline,
// split-K and epilogue are diff_gemm_sm90.cuh's; this file supplies the
// producer of the A operand: the x_t and x_prev chunks are staged raw
// (cp.async, 64 bytes a row each) and every thread builds its wgmma A
// fragments from them in registers:
//
//   d = x_t - x_prev a byte lane at a time (mod 256). A word whose lanes
//   cannot leave [-127, 127] (no signed overflow, no -128) is its own lo
//   plane and has hi = 0; otherwise the word takes the exact split
//   lo = clamp(Δ, -127, 127), hi = Δ - lo (split_delta4) and the
//   warpgroup's vote turns the hi product on. class-1 tiles (max|Δ| <= 7)
//   go the same way under low_bits = 8 (the reference's merged predicate).
//
// low_bits = 4 (int4_low): a class-1 chunk's lanes go through the int4
// lane format instead (nibble_lanes: the pack -> unpack round trip, exact
// in [-8, 7], which the class-1 verdict guarantees) and skip the split and
// the vote. Hopper has no int4 x int8 tensor-core product, so the packed
// word exists only in registers; both branches give the same int32 result.
//
// What bounds it: bytes at the path's B = 2 shapes (the int32 y_prev read
// and output write are most of them), and it does less work the more
// class-0 tiles the data has. W[b] is (N, K) row-major, K-major as int8
// wgmma reads it (the wrapper lays a (K, N) weight out so first). y_prev
// may be null (the bare diff contribution). M, N, K are multiples of 128.
// `splits` is 0 for the kernel's own K split (launch_splits) or a forced
// count; ditto_diff_gemm_splits reports the kernel's choice.
#include "diff_gemm_sm90.cuh"

namespace {

using namespace ditto;
using namespace ditto::sm90;

struct DiffProducer {
  static constexpr bool CLASSED = true;
  static constexpr bool A_SMEM = false;
  static constexpr int XP_OFF = GM * GK;           // x_t, then x_prev: swizzled 64-byte rows
  static constexpr int A_BYTES = 2 * GM * GK;

  __device__ static void load(uint8_t* st, const GemmArgs& a, int64_t b, int64_t m0,
                              int64_t k0, int /*cls*/) {
    const int8_t* xt = a.a0 + b * a.sa0 + m0 * a.k + k0;
    const int8_t* xp = a.a1 + b * a.sa1 + m0 * a.k + k0;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int v = threadIdx.x + it * GTHREADS;
      const int r = v >> 2, c = (v & 3) * 16;
      cp_async16(st + row64(r, c), xt + r * a.k + c);
      cp_async16(st + XP_OFF + row64(r, c), xp + r * a.k + c);
    }
  }

  __device__ static bool frags(const uint8_t* st, const GemmArgs& a, int cls, int row0, int t4,
                               uint32_t (&lo)[2][4], uint32_t (&hi)[2][4], uint32_t& any) {
    const uint8_t* xs = st;
    const uint8_t* ps = st + XP_OFF;
    const bool low4 = a.low4 && cls == 1;
    uint32_t out = 0;  // lanes whose Δ leaves [-127, 127]
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int off = row64(row0 + 8 * (q & 1), frag_k(s, q, t4));
        const uint32_t x = *reinterpret_cast<const uint32_t*>(xs + off);
        const uint32_t y = *reinterpret_cast<const uint32_t*>(ps + off);
        const uint32_t d = sub_bytes(x, y);
        lo[s][q] = low4 ? nibble_lanes(d) : d;
        hi[s][q] = 0;
        // signed overflow of a lane (|Δ| > 127 beyond a byte), or a -128 lane
        out |= ((x ^ y) & (x ^ d)) | has_byte_80(d);
      }
    if (low4) return false;
    if (out & 0x80808080u) {  // rare: the exact split for this thread's words
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int off = row64(row0 + 8 * (q & 1), frag_k(s, q, t4));
          const uint32_t x = *reinterpret_cast<const uint32_t*>(xs + off);
          const uint32_t y = *reinterpret_cast<const uint32_t*>(ps + off);
          int dd[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) dd[i] = byte_s8(x, 8 * i) - byte_s8(y, 8 * i);
          any |= split_delta4(dd, lo[s][q], hi[s][q]);
        }
    }
    return true;
  }
};

}  // namespace

extern "C" int ditto_diff_matmul(const void* xt, const void* xp, const void* w,
                                 const void* y_prev, const void* classes, void* out,
                                 int64_t batch, int64_t m, int64_t n, int64_t k, int64_t sx,
                                 int64_t sw, int64_t so, int64_t sc, int low_bits, int splits,
                                 void* stream) {
  GemmArgs a = {};
  a.a0 = static_cast<const int8_t*>(xt);
  a.a1 = static_cast<const int8_t*>(xp);
  a.w = static_cast<const int8_t*>(w);
  a.classes = static_cast<const int32_t*>(classes);
  a.y_prev = static_cast<const int32_t*>(y_prev);
  a.out = static_cast<int32_t*>(out);
  a.m = m;
  a.n = n;
  a.k = k;
  a.sa0 = a.sa1 = sx;
  a.sw = sw;
  a.so = so;
  a.sc = sc;
  a.splits = splits;
  a.low4 = low_bits == 4;
  return launch_diff_gemm<DiffProducer>(a, batch, stream);
}

// The K split the three GEMMs (both difference GEMMs and int8_matmul)
// launch a (batch, m, n, k) product with on the current device (0 or
// negative: see launch_splits).
extern "C" int ditto_diff_gemm_splits(int64_t batch, int64_t m, int64_t n, int64_t k) {
  return launch_splits(batch, m, n, k);
}
