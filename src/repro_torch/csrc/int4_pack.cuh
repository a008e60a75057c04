// Packed-int4 lane format on the card: the device counterparts of
// kernels/int4_pack.py that the fused encode (diff_encode_fused.cu) writes
// the Δ-cache with.
//
// One byte holds two adjacent-K lanes of a difference: the EVEN lane in
// bits 0-3, the ODD lane in bits 4-7, as two's-complement nibbles.
// Unpacking is exact for every lane value in [-8, 7]; a class-1 tile
// (max|delta| <= 7) is inside that range. The GEMMs that read the format
// unpack it in registers (diff_gemm_sm90.cuh: nibble_lanes, spread_nibbles).
#pragma once

#include "lanes.cuh"

namespace ditto {

// Pack two lanes into one byte (bits 0-7 of the result). Unsigned
// arithmetic: a left shift of a negative int is undefined in C++17.
__device__ __forceinline__ uint32_t pack_int4_pair(int even, int odd) {
  return ((uint32_t(odd) & 0xfu) << 4) | (uint32_t(even) & 0xfu);
}

// The even (low) lane of the byte at bit `shift` of w, sign-extended.
__device__ __forceinline__ int unpack_int4_lo(uint32_t w, int shift) {
  return int(((w >> shift) & 0xfu) ^ 8u) - 8;
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

}  // namespace ditto
