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

// The low nibbles of the 4 byte lanes of w in 16 bits, lane i in bits
// 4i .. 4i + 3 (the even lane of each byte pair in the low nibble).
__device__ __forceinline__ uint32_t pack_nibbles4(uint32_t w) {
  w &= 0x0f0f0f0fu;
  w = (w | (w >> 4)) & 0x00ff00ffu;
  return (w | (w >> 8)) & 0xffffu;
}

// Pack the 16 int8 lanes of one 16-byte vector into 8 bytes.
__device__ __forceinline__ uint2 pack_int4_x16(uint4 v) {
  return make_uint2(pack_nibbles4(v.x) | (pack_nibbles4(v.y) << 16),
                    pack_nibbles4(v.z) | (pack_nibbles4(v.w) << 16));
}

}  // namespace ditto
