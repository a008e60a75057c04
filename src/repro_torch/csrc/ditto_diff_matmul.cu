// Tile-skipping temporal-difference GEMM, batched:
//   out[b] = y_prev[b] + (x_t[b] - x_prev[b]) @ W[b]        (exact int32)
//
// delta = x_t - x_prev lies in [-254, 254] and does not fit an int8 mma
// operand, so each staged chunk is split exactly into two int8 planes
//   lo = clamp(delta, -127, 127),  hi = delta - lo   (|hi| <= 127)
// and delta @ W = lo @ W + hi @ W accumulates into the same int32
// fragments. hi is all-zero unless some |delta| > 127 in the chunk; the
// block votes on that (__syncthreads_or) and skips the second product when
// it is not needed, so class-1 chunks and most class-2 chunks issue one
// mma pass. A class-0 tile (classes[b][i][kk] == 0, from diff_encode)
// issues no load and no product at all.
//
// low_bits = 4 (int4_low): a class-1 chunk is staged as packed int4 x 2
// words instead (int4_pack.cuh: 32 bytes a row, half the int8 delta) and
// unpacked into the mma operand as the fragments load. The class-1
// verdict (max|delta| <= 7) keeps every lane inside the exact [-8, 7]
// range, so the result equals the int8 branch bit for bit. Class-2 chunks
// keep the exact lo/hi split.
//
// W[b] is (K, N) row-major, or (N, K) row-major when w_t. y_prev may be
// null (the bare diff contribution). M, N, K are multiples of 128.
#include "int4_pack.cuh"

namespace {

using namespace ditto;

// Split the 4 byte lanes of x_t - x_prev into the (lo, hi) int8 planes;
// returns nonzero iff any hi lane is nonzero.
__device__ __forceinline__ uint32_t split4(uint32_t xt, uint32_t xp, uint32_t& lo,
                                           uint32_t& hi) {
  int d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = byte_s8(xt, 8 * i) - byte_s8(xp, 8 * i);
  return split_delta4(d, lo, hi);
}

__global__ void __launch_bounds__(THREADS)
    diff_matmul_kernel(const int8_t* __restrict__ xt, const int8_t* __restrict__ xp,
                       const int8_t* __restrict__ w, const int32_t* __restrict__ y_prev,
                       const int32_t* __restrict__ classes, int32_t* __restrict__ out,
                       int64_t m, int64_t n, int64_t k, int64_t sx, int64_t sw,
                       int64_t so, int64_t sc, bool w_t, bool int4_low) {
  __shared__ __align__(16) int8_t Lo[BM][PITCH];
  __shared__ __align__(16) int8_t Hi[BM][PITCH];
  __shared__ __align__(16) int8_t Bs[BN][PITCH];
  __shared__ __align__(16) int8_t Ps[BM][PACKED_PITCH];
  const int64_t b = blockIdx.z;
  const int64_t m0 = int64_t(blockIdx.y) * BM, n0 = int64_t(blockIdx.x) * BN;
  xt += b * sx + m0 * k;
  xp += b * sx + m0 * k;
  w += b * sw;
  const int32_t* cls_row = classes + b * sc + blockIdx.y * (k / TILE_K);
  Frag acc;
  zero(acc);
  for (int64_t k0 = 0; k0 < k; k0 += BK) {
    const int cls = cls_row[k0 / TILE_K];  // uniform over the block
    if (cls == 0) continue;
    if (int4_low && cls == 1) {
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int v = threadIdx.x + it * THREADS;
        const int r = v >> 2, c = (v & 3) * 16;
        const uint4 a = *reinterpret_cast<const uint4*>(xt + r * k + k0 + c);
        const uint4 p = *reinterpret_cast<const uint4*>(xp + r * k + k0 + c);
        // per-byte difference mod 256: its low nibble is delta's
        const uint4 d = make_uint4(__vsub4(a.x, p.x), __vsub4(a.y, p.y), __vsub4(a.z, p.z),
                                   __vsub4(a.w, p.w));
        *reinterpret_cast<uint2*>(&Ps[r][c / 2]) = pack_int4_x16(d);
      }
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
      const uint4 a = *reinterpret_cast<const uint4*>(xt + r * k + k0 + c);
      const uint4 p = *reinterpret_cast<const uint4*>(xp + r * k + k0 + c);
      uint4 lo, hi;
      any |= split4(a.x, p.x, lo.x, hi.x);
      any |= split4(a.y, p.y, lo.y, hi.y);
      any |= split4(a.z, p.z, lo.z, hi.z);
      any |= split4(a.w, p.w, lo.w, hi.w);
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

extern "C" int ditto_diff_matmul(const void* xt, const void* xp, const void* w,
                                 const void* y_prev, const void* classes, void* out,
                                 int64_t batch, int64_t m, int64_t n, int64_t k, int64_t sx,
                                 int64_t sw, int64_t so, int64_t sc, int w_t, int low_bits,
                                 void* stream) {
  const dim3 grid(unsigned(n / BN), unsigned(m / BM), unsigned(batch));
  diff_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xt), static_cast<const int8_t*>(xp),
      static_cast<const int8_t*>(w), static_cast<const int32_t*>(y_prev),
      static_cast<const int32_t*>(classes), static_cast<int32_t*>(out), m, n, k, sx, sw, so,
      sc, w_t != 0, low_bits == 4);
  return int(cudaGetLastError());
}
