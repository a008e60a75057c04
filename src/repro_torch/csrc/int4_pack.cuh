// Packed-int4 lane format on the card: the device counterparts of
// kernels/int4_pack.py, and the tensor-core product that reads it.
//
// One byte holds two adjacent-K lanes of a difference: the EVEN lane in
// bits 0-3, the ODD lane in bits 4-7, as two's-complement nibbles.
// Unpacking is exact for every lane value in [-8, 7]; a class-1 tile
// (max|delta| <= 7) is inside that range.
//
// Hopper has no int4 x int8 tensor-core product (mma.sync takes s4 only
// against s4), so a packed chunk is a half-width storage format in shared
// memory (32 bytes a row per 64-K chunk instead of 64): mma_chunk_packed
// unpacks each 16-bit pair of words into the four int8 lanes of an
// mma.sync operand register as it loads the fragment.
#pragma once

#include "tile_mma.cuh"

namespace ditto {

constexpr int PACKED_PITCH = BK / 2 + 16;  // smem row pitch of a packed chunk, bytes

// Pack two lanes into one byte (bits 0-7 of the result). Unsigned
// arithmetic: a left shift of a negative int is undefined in C++17.
__device__ __forceinline__ uint32_t pack_int4_pair(int even, int odd) {
  return ((uint32_t(odd) & 0xfu) << 4) | (uint32_t(even) & 0xfu);
}

// The even (low) lane of the byte at bit `shift` of w, sign-extended.
__device__ __forceinline__ int unpack_int4_lo(uint32_t w, int shift) {
  return int(((w >> shift) & 0xfu) ^ 8u) - 8;
}

// The odd (high) lane of the byte at bit `shift` of w, sign-extended by an
// arithmetic shift, as byte_s8 does for a whole byte.
__device__ __forceinline__ int unpack_int4_hi(uint32_t w, int shift) {
  return int32_t(w << (24 - shift)) >> 28;
}

// Two packed bytes (bits 0-15 of p) -> the four int8 lanes they hold, in
// K order, as one mma.sync operand register.
__device__ __forceinline__ uint32_t unpack_int4_x4(uint32_t p) {
  return (uint32_t(unpack_int4_lo(p, 0)) & 0xffu) |
         ((uint32_t(unpack_int4_hi(p, 0)) & 0xffu) << 8) |
         ((uint32_t(unpack_int4_lo(p, 8)) & 0xffu) << 16) |
         ((uint32_t(unpack_int4_hi(p, 8)) & 0xffu) << 24);
}

// Pack the 16 int8 lanes of one 16-byte vector into 8 bytes.
__device__ __forceinline__ uint2 pack_int4_x16(uint4 v) {
  const uint32_t in[4] = {v.x, v.y, v.z, v.w};
  uint32_t out[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = pack_int4_pair(byte_s8(in[i], 0), byte_s8(in[i], 8));
    const uint32_t hi = pack_int4_pair(byte_s8(in[i], 16), byte_s8(in[i], 24));
    out[i >> 1] |= (lo | (hi << 8)) << ((i & 1) * 16);
  }
  return make_uint2(out[0], out[1]);
}

__device__ __forceinline__ uint32_t lds16(const int8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// acc += unpack(Ps)(128 x BK) @ Bs(BK x 128) for this warp's 64 x 32
// sub-tile, where Ps[row][c] holds K lanes 2c and 2c + 1 of the chunk.
// The same fragment walk as mma_chunk: the four K lanes at k (a multiple
// of 4) are the two packed bytes at k / 2.
__device__ __forceinline__ void mma_chunk_packed(Frag& acc, const int8_t (*Ps)[PACKED_PITCH],
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
      a[i][0] = unpack_int4_x4(lds16(&Ps[r][(ks + t4) / 2]));
      a[i][1] = unpack_int4_x4(lds16(&Ps[r + 8][(ks + t4) / 2]));
      a[i][2] = unpack_int4_x4(lds16(&Ps[r][(ks + 16 + t4) / 2]));
      a[i][3] = unpack_int4_x4(lds16(&Ps[r + 8][(ks + 16 + t4) / 2]));
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

}  // namespace ditto
