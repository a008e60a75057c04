// Fused-flow difference GEMM, batched, for sm_90a: from the Δ-cache of
// diff_encode_fused.cu (never from x_t / x_prev),
//   out[b] = y_prev[b] + delta[b] @ W[b]                  (exact int32)
// or, with y_prev null, the bare contribution delta @ W.
//
// Replaces src/repro/kernels/fused_step.py: ditto_fused_matmul (the Pallas
// body _fused_kernel). The mainloop, pipeline, split-K and epilogue are
// diff_gemm_sm90.cuh's; this file supplies the producer of the A operand,
// which stages per live 64-K chunk only the planes its class needs:
//   class 1: dc (32 bytes a row: two int4 lanes a byte); the lanes are Δ,
//            sign-extended nibble by nibble into the wgmma fragment;
//   class 2: dc and dh; each lane is rebuilt as Δ = lo + 16 dh, written
//            n + 16 e with n the raw nibble and e = dh - (n >> 3), so the
//            byte of Δ is e << 4 | n. A word whose lanes all lie in
//            [-127, 127] is its own lo plane; otherwise it takes the exact
//            split lo = clamp(Δ, ±127), hi = Δ - lo (split_delta4) and the
//            warpgroup's vote turns the hi product on.
// Class-0 tiles stage nothing. The reference's hold maps (which let the
// TPU pipeline elide copies of skipped blocks) have no counterpart: the
// live-tile list never issues them. What bounds it: bytes at the path's
// B = 2 shapes, the int32 y_prev read and output write the largest share.
// W[b] is (N, K) row-major (K-major). M, N, K are multiples of 128.
// `splits` is 0 for the kernel's own K split or a forced count.
#include "diff_gemm_sm90.cuh"

namespace {

using namespace ditto;
using namespace ditto::sm90;

struct FusedProducer {
  static constexpr bool CLASSED = true;
  static constexpr bool A_SMEM = false;
  static constexpr int DH_OFF = GM * GK / 2;  // dc: swizzled 32-byte rows, then dh: 64-byte
  static constexpr int A_BYTES = DH_OFF + GM * GK;

  __device__ static void load(uint8_t* st, const GemmArgs& a, int64_t b, int64_t m0,
                              int64_t k0, int cls) {
    const int64_t kh = a.k / 2;  // dc row length in bytes
    {
      const int r = threadIdx.x >> 1, c = (threadIdx.x & 1) * 16;  // 64 rows x 32 bytes
      cp_async16(st + row32(r, c), a.a0 + b * a.sa0 + (m0 + r) * kh + k0 / 2 + c);
    }
    if (cls != 2) return;
    const int8_t* dh = a.a1 + b * a.sa1 + m0 * a.k + k0;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int v = threadIdx.x + it * GTHREADS;
      const int r = v >> 2, c = (v & 3) * 16;
      cp_async16(st + DH_OFF + row64(r, c), dh + r * a.k + c);
    }
  }

  __device__ static bool frags(const uint8_t* st, const GemmArgs& /*a*/, int cls, int row0,
                               int t4, uint32_t (&lo)[2][4], uint32_t (&hi)[2][4],
                               uint32_t& any) {
    uint32_t out = 0;  // lanes whose Δ leaves [-127, 127]
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = row0 + 8 * (q & 1), k = frag_k(s, q, t4);
        const uint32_t n = nibbles(st, r, k);
        hi[s][q] = 0;
        if (cls == 1) {
          lo[s][q] = nibble_lanes(n);
          continue;
        }
        const uint32_t e = high_part(st, r, k, n);
        const uint32_t d = ((e << 4) & 0xf0f0f0f0u) | n;  // Δ mod 256
        lo[s][q] = d;
        // Δ's sign is e's; a lane whose byte disagrees, or is -128, is outside [-127, 127]
        out |= (d ^ e) | has_byte_80(d);
      }
    if (cls == 1) return false;
    if (out & 0x80808080u) {  // rare: the exact split for this thread's words
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = row0 + 8 * (q & 1), k = frag_k(s, q, t4);
          const uint32_t n = nibbles(st, r, k), e = high_part(st, r, k, n);
          int dd[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) dd[i] = 16 * byte_s8(e, 8 * i) + int((n >> (8 * i)) & 0xfu);
          any |= split_delta4(dd, lo[s][q], hi[s][q]);
        }
    }
    return true;
  }

  // The raw nibbles of K lanes k .. k + 3 of row r, one a byte lane.
  __device__ static uint32_t nibbles(const uint8_t* st, int r, int k) {
    return spread_nibbles(*reinterpret_cast<const uint16_t*>(st + row32(r, k / 2)));
  }

  // e = dh - (the nibble's sign bit), lane by lane without borrows between
  // lanes, so that Δ = n + 16 e.
  __device__ static uint32_t high_part(const uint8_t* st, int r, int k, uint32_t n) {
    const uint32_t h = *reinterpret_cast<const uint32_t*>(st + DH_OFF + row64(r, k));
    return ((h | 0x80808080u) - ((n >> 3) & 0x01010101u)) ^ (~h & 0x80808080u);
  }
};

}  // namespace

extern "C" int ditto_fused_matmul(const void* w, const void* dc, const void* dh,
                                  const void* classes, const void* y_prev, void* out,
                                  int64_t batch, int64_t m, int64_t n, int64_t k, int64_t sw,
                                  int64_t sd, int64_t so, int64_t sc, int splits, void* stream) {
  GemmArgs a = {};
  a.a0 = static_cast<const int8_t*>(dc);
  a.a1 = static_cast<const int8_t*>(dh);
  a.w = static_cast<const int8_t*>(w);
  a.classes = static_cast<const int32_t*>(classes);
  a.y_prev = static_cast<const int32_t*>(y_prev);
  a.out = static_cast<int32_t*>(out);
  a.m = m;
  a.n = n;
  a.k = k;
  a.sa0 = sd / 2;
  a.sa1 = sd;
  a.sw = sw;
  a.so = so;
  a.sc = sc;
  a.splits = splits;
  a.low4 = 0;
  return launch_diff_gemm<FusedProducer>(a, batch, stream);
}
