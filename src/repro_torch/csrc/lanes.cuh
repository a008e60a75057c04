// Byte-lane helpers of the fused encode and the difference GEMMs: byte_s8
// (diff_encode_fused.cu, int4_pack.cuh, the GEMMs) and split_delta4 (the
// difference GEMMs of diff_gemm_sm90.cuh).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ditto {

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

}  // namespace ditto
