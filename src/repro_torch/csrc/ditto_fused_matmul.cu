// Fused-flow difference GEMM, batched: from the delta cache of
// diff_encode_fused.cu (never from x_t / x_prev),
//   out[b] = y_prev[b] + delta[b] @ W[b]                  (exact int32)
// with y_prev added in the epilogue (store_tile) or, when null, the bare
// contribution delta @ W. Per 64-K chunk of the 128 x 128 output tile the
// block branches on its K-tile's class:
//   class 0: no load and no product;
//   class 1: loads the dc chunk (32 bytes a row: the nibbles are delta)
//            and W, and runs one product on the unpacked lanes
//            (mma_chunk_packed);
//   class 2: loads dc, dh and W, rebuilds delta = lo + 16 * dh lane by
//            lane while staging, splits it exactly into int8 lo / hi
//            planes (split_delta4) and accumulates lo @ W + hi @ W in one
//            accumulator, skipping hi @ W when the block votes every
//            |delta| <= 127.
// W[b] is (K, N) row-major, or (N, K) row-major when w_t. M, N, K are
// multiples of 128.
#include "int4_pack.cuh"

namespace {

using namespace ditto;

// Rebuild the 4 deltas of packed-byte pair pc (bits `s`..`s`+15) and high
// bytes ph, then split them into (lo, hi) int8 planes; nonzero iff any hi.
__device__ __forceinline__ uint32_t rebuild_split4(uint32_t pc, int s, uint32_t ph,
                                                   uint32_t& lo, uint32_t& hi) {
  const int d[4] = {unpack_int4_lo(pc, s) + 16 * byte_s8(ph, 0),
                    unpack_int4_hi(pc, s) + 16 * byte_s8(ph, 8),
                    unpack_int4_lo(pc, s + 8) + 16 * byte_s8(ph, 16),
                    unpack_int4_hi(pc, s + 8) + 16 * byte_s8(ph, 24)};
  return split_delta4(d, lo, hi);
}

__global__ void __launch_bounds__(THREADS)
    fused_matmul_kernel(const int8_t* __restrict__ w, const int8_t* __restrict__ dc,
                        const int8_t* __restrict__ dh, const int32_t* __restrict__ classes,
                        const int32_t* __restrict__ y_prev, int32_t* __restrict__ out,
                        int64_t m, int64_t n, int64_t k, int64_t sw, int64_t sd, int64_t so,
                        int64_t sc, bool w_t) {
  __shared__ __align__(16) int8_t Lo[BM][PITCH];
  __shared__ __align__(16) int8_t Hi[BM][PITCH];
  __shared__ __align__(16) int8_t Bs[BN][PITCH];
  __shared__ __align__(16) int8_t Ps[BM][PACKED_PITCH];
  const int64_t b = blockIdx.z;
  const int64_t m0 = int64_t(blockIdx.y) * BM, n0 = int64_t(blockIdx.x) * BN;
  const int64_t kh = k / 2;  // dc row length in bytes
  dc += b * (sd / 2) + m0 * kh;
  dh += b * sd + m0 * k;
  w += b * sw;
  const int32_t* cls_row = classes + b * sc + blockIdx.y * (k / TILE_K);
  Frag acc;
  zero(acc);
  for (int64_t k0 = 0; k0 < k; k0 += BK) {
    const int cls = cls_row[k0 / TILE_K];  // uniform over the block
    if (cls == 0) continue;
    if (cls == 1) {
      const int r = threadIdx.x >> 1, c = (threadIdx.x & 1) * 16;  // 128 rows x 32 bytes
      *reinterpret_cast<uint4*>(&Ps[r][c]) =
          *reinterpret_cast<const uint4*>(dc + r * kh + k0 / 2 + c);
      load_w(Bs, w, w_t, n, k, n0, k0);
      __syncthreads();
      mma_chunk_packed(acc, Ps, Bs);
      __syncthreads();
      continue;
    }
    uint32_t any = 0;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int v = threadIdx.x + it * THREADS;
      const int r = v >> 2, c = (v & 3) * 16;
      const uint2 pc = *reinterpret_cast<const uint2*>(dc + r * kh + (k0 + c) / 2);
      const uint4 ph = *reinterpret_cast<const uint4*>(dh + r * k + k0 + c);
      uint4 lo, hi;
      any |= rebuild_split4(pc.x, 0, ph.x, lo.x, hi.x);
      any |= rebuild_split4(pc.x, 16, ph.y, lo.y, hi.y);
      any |= rebuild_split4(pc.y, 0, ph.z, lo.z, hi.z);
      any |= rebuild_split4(pc.y, 16, ph.w, lo.w, hi.w);
      *reinterpret_cast<uint4*>(&Lo[r][c]) = lo;
      *reinterpret_cast<uint4*>(&Hi[r][c]) = hi;
    }
    load_w(Bs, w, w_t, n, k, n0, k0);
    const int need_hi = __syncthreads_or(any != 0);
    mma_chunk(acc, Lo, Bs);
    if (need_hi) mma_chunk(acc, Hi, Bs);
    __syncthreads();
  }
  store_tile(acc, out + b * so, y_prev == nullptr ? nullptr : y_prev + b * so, n, m0, n0);
}

}  // namespace

extern "C" int ditto_fused_matmul(const void* w, const void* dc, const void* dh,
                                  const void* classes, const void* y_prev, void* out,
                                  int64_t batch, int64_t m, int64_t n, int64_t k, int64_t sw,
                                  int64_t sd, int64_t so, int64_t sc, int w_t, void* stream) {
  const dim3 grid(unsigned(n / BN), unsigned(m / BM), unsigned(batch));
  fused_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), static_cast<const int8_t*>(dc),
      static_cast<const int8_t*>(dh), static_cast<const int32_t*>(classes),
      static_cast<const int32_t*>(y_prev), static_cast<int32_t*>(out), m, n, k, sw, sd, so,
      sc, w_t != 0);
  return int(cudaGetLastError());
}
