// int8 tensor-core tile machinery of int8_matmul.cu (mma.sync, synchronous
// staging), and the lane helpers every kernel shares: byte_s8 (the encode
// kernels) and split_delta4 (the difference GEMMs of diff_gemm_sm90.cuh).
//
// One thread block computes one 128 x 128 int32 output tile with
// mma.sync.m16n8k32 (s8 x s8 -> s32). 256 threads = 8 warps laid out
// 2 (rows) x 4 (cols); each warp owns a 64 x 32 sub-tile, i.e. 4 x 4
// m16n8 accumulator fragments (64 int32 registers a thread). K advances
// in chunks of BK = 64 bytes staged through shared memory.
//
// Shared-memory tiles are stored K-contiguous for both operands:
//   As[row][k]  (A, row-major)     Bs[col][k]  (B, "col" layout of mma.sync)
// with a row pitch of 80 bytes (20 words): the eight row groups of one
// fragment load then land on disjoint bank quads, so fragment loads are
// free of bank conflicts.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ditto {

constexpr int BM = 128;       // output tile rows  (= the TPU kernels' bm)
constexpr int BN = 128;       // output tile cols  (= bn)
constexpr int BK = 64;        // K bytes staged per chunk (two k32 mma steps)
constexpr int TILE_K = 128;   // K extent of one diff_encode class tile (= bk)
constexpr int THREADS = 256;
constexpr int PITCH = BK + 16;  // smem row pitch in bytes

__device__ __forceinline__ int byte_s8(uint32_t w, int shift) {
  return int32_t(w << (24 - shift)) >> 24;  // sign-extend the byte at bit `shift`
}

// Split four differences d[0..3], each in [-254, 254], exactly into two
// int8 planes one lane a byte: lo = clamp(d, -127, 127) and hi = d - lo
// (|hi| <= 127). Returns nonzero iff any hi lane is nonzero.
__device__ __forceinline__ uint32_t split_delta4(const int (&d)[4], uint32_t& lo,
                                                 uint32_t& hi) {
  uint32_t any = 0;
  lo = hi = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = max(-127, min(127, d[i]));
    const int h = d[i] - l;
    any |= uint32_t(h);
    lo |= (uint32_t(l) & 0xffu) << (8 * i);
    hi |= (uint32_t(h) & 0xffu) << (8 * i);
  }
  return any;
}

struct Frag {
  int32_t c[4][4][4];  // [m16 tile][n8 tile][register]
};

__device__ __forceinline__ void zero(Frag& f) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) f.c[i][j][r] = 0;
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc += As(128 x BK) @ Bs(BK x 128) for this warp's 64 x 32 sub-tile.
__device__ __forceinline__ void mma_chunk(Frag& acc, const int8_t (*As)[PITCH],
                                          const int8_t (*Bs)[PITCH]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = (lane & 3) * 4;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 32) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wm + i * 16 + g;
      a[i][0] = lds32(&As[r][ks + t4]);
      a[i][1] = lds32(&As[r + 8][ks + t4]);
      a[i][2] = lds32(&As[r][ks + 16 + t4]);
      a[i][3] = lds32(&As[r + 8][ks + 16 + t4]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = wn + j * 8 + g;
      b[j][0] = lds32(&Bs[n][ks + t4]);
      b[j][1] = lds32(&Bs[n][ks + 16 + t4]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc.c[i][j], a[i], b[j]);
  }
}

// Stage a 128-row x BK-byte K-contiguous block (row stride ld bytes) into
// smem: 512 16-byte vectors, two per thread, coalesced along K.
__device__ __forceinline__ void load_rows(int8_t (*dst)[PITCH], const int8_t* src,
                                          int64_t ld) {
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int v = threadIdx.x + it * THREADS;
    const int r = v >> 2, c = (v & 3) * 16;
    *reinterpret_cast<int4*>(&dst[r][c]) =
        *reinterpret_cast<const int4*>(src + r * ld + c);
  }
}

// Stage a BK x 128 block of a (K, N) row-major weight (row stride ld bytes)
// into Bs[n][k]: each thread reads 4 k-rows x 4 n-bytes (coalesced along N)
// and transposes the 4 x 4 byte block in registers.
__device__ __forceinline__ void load_kn_transposed(int8_t (*dst)[PITCH],
                                                   const int8_t* src, int64_t ld) {
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int v = threadIdx.x + it * THREADS;
    const int kq = (v >> 5) * 4, nq = (v & 31) * 4;
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = *reinterpret_cast<const uint32_t*>(src + (kq + j) * ld + nq);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 8 * i;
      const uint32_t col = ((w[0] >> s) & 0xffu) | (((w[1] >> s) & 0xffu) << 8) |
                           (((w[2] >> s) & 0xffu) << 16) | (((w[3] >> s) & 0xffu) << 24);
      *reinterpret_cast<uint32_t*>(&dst[nq + i][kq]) = col;
    }
  }
}

// Stage the weight chunk (K rows [k0, k0 + BK), cols [n0, n0 + BN)) into
// Bs[n][k] from either layout: (N, K) row-major when w_t, else (K, N).
__device__ __forceinline__ void load_w(int8_t (*Bs)[PITCH], const int8_t* w, bool w_t,
                                       int64_t n, int64_t k, int64_t n0, int64_t k0) {
  if (w_t)
    load_rows(Bs, w + n0 * k + k0, k);
  else
    load_kn_transposed(Bs, w + k0 * n + n0, n);
}

// out[row][col] = acc (+ y_prev[row][col]) for this warp's fragments; the
// output tile starts at (m0, n0) of an (M, N) row-major int32 matrix.
__device__ __forceinline__ void store_tile(const Frag& acc, int32_t* out,
                                           const int32_t* y_prev, int64_t n,
                                           int64_t m0, int64_t n0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = m0 + wm + i * 16 + g + h * 8;
        const int64_t off = row * n + n0 + wn + j * 8 + t2;
        int2 v = make_int2(acc.c[i][j][2 * h], acc.c[i][j][2 * h + 1]);
        if (y_prev != nullptr) {
          const int2 p = *reinterpret_cast<const int2*>(y_prev + off);
          v.x += p.x;
          v.y += p.y;
        }
        *reinterpret_cast<int2*>(out + off) = v;
      }
}

}  // namespace ditto
